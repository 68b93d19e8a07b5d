"""YOLO-Seg++ decoder training through
`yolou_tpu_torch.engine.trainer_decoder.DecoderTrainer.step`.

`distinct` batches of `batch` rows are made from the seed and wait in
pinned host memory: uint8 4-channel images at `size`^2 (smooth noise),
uint8 binary masks (blobs of the same smoothness) and float32 conditioning
maps at `size`/8 in [0, 1], as the trainer's epoch loop feeds them
(`DecoderDataset.batches(u8=True)`). One step a request, batches in a
seeded order, round robin; nothing is fetched to the host, as in
`DecoderTrainer.train`, and the window ends with the card synchronised.

Set-up builds the trainer once and drives it through its first three
steps by the window's own call, on three different batches; the window
goes on with the same trainer. What the check compares comes from those
steps: each step's loss, each leaf's first gradient norm (from AdamW's
first moment after one step, m1 = (1 - beta1) g1) and each leaf's change
after the three steps, against the plain reference trained the same
three steps from the same weights.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import weights
from ..reference import train_decoder as ref_train
from ..reference.segpp import SegPP
from ..roofline import counted_flops
from . import DTYPES, ClosedLoop

FIRST_STEPS = 3


class Driver(ClosedLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        b, s, ch = traffic["batch"], traffic["size"], cfg["ch"]
        n = traffic["distinct"] * b
        self.images_per_request = b
        if traffic["warmup_requests"] < FIRST_STEPS:
            raise ValueError(f"the first {FIRST_STEPS} steps are set-up's")
        gen = weights.generator(seed, device, 1)
        img = weights.smooth_noise(gen, (n, ch, s, s), traffic["cells"], device)
        blobs = weights.smooth_noise(gen, (n, 1, s, s), traffic["cells"],
                                     device, grain=0.0)
        om = weights.smooth_noise(gen, (n, 1, s // 8, s // 8), 1, device)
        self.order = torch.randperm(traffic["distinct"], generator=gen,
                                    device=device).tolist()
        ref = weights.build(SegPP, cfg["variant"], cfg["nc"], ch, cfg["task"],
                            device=device)
        weights.segpp_state(ref, seed, img[:traffic["calibration_images"]])
        self.state = weights.state_dict(ref)
        del ref
        img_u8 = (img * 255.0).round_().to(torch.uint8)
        mask_u8 = (blobs > traffic["mask_threshold"]).to(torch.uint8) * 255
        pin = device.type == "cuda"

        def host(t):
            t = t.permute(0, 2, 3, 1).contiguous()
            return t.to("cpu").pin_memory() if pin else t
        self.batches = list(zip(host(img_u8).split(b), host(mask_u8).split(b),
                                host(om).split(b)))
        del img, blobs, om, img_u8, mask_u8
        self._build_program()

    def _build_program(self):
        from yolou_tpu_torch.engine.trainer_decoder import (
            DecoderTrainConfig, DecoderTrainer)
        from yolou_tpu_torch.models.segpp import build_segpp
        cfg, t = self.cfg, self.traffic
        model = build_segpp(cfg["arch"], cfg["variant"], cfg["nc"], cfg["ch"],
                            cfg["task"], use_logits=cfg["use_logits"],
                            dtype=DTYPES[cfg["dtype"]], device=self.device)
        model.load_state_dict(self.state, strict=True)
        tcfg = DecoderTrainConfig(image_size=t["size"], batch_size=t["batch"],
                                  lr=t["lr"], weight_decay=t["weight_decay"],
                                  epochs=t["epochs"])
        self.trainer = DecoderTrainer(model, data_root="", cfg=tcfg,
                                      device=self.device)
        self.trainer.ensure_ready(t["steps_per_epoch"])
        self.decay_steps = t["epochs"] * t["steps_per_epoch"]
        self.names = [n for n, _ in model.named_parameters()
                      if not n.startswith("yolo.")]
        self.start = [p.detach().clone()
                      for p in self.trainer.model.decoder_parameters()]
        self.losses = []

    def warm(self) -> None:
        for i in range(self.traffic["warmup_requests"]):
            self.request(i)
        self.sync()

    def request(self, i: int) -> None:
        img, mask, om = self.batches[self.order[i % len(self.order)]]
        loss, _ = self.trainer.step(img, mask, om)
        if i < FIRST_STEPS:
            self._record(i, loss)

    def _record(self, i: int, loss: torch.Tensor) -> None:
        """The program's readings of its first steps (set-up only)."""
        self.losses.append(loss.detach().clone())
        params = list(self.trainer.model.decoder_parameters())
        if i == 0:
            beta1 = self.trainer.optimizer.param_groups[0]["betas"][0]
            st = self.trainer.optimizer.state
            # no moment where the optimizer did not step: a gradient of 0
            self.first_grad = torch.stack(
                [st[p]["exp_avg"].norm() / (1.0 - beta1)
                 if "exp_avg" in st[p] else p.new_zeros(()) for p in params])
        if i == FIRST_STEPS - 1:
            self.change = torch.stack([(p.detach() - s).norm()
                                       for p, s in zip(params, self.start)])

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flops_per_request(self) -> float:
        """Forward and backward of one step over the reference (meta
        device); the optimizer's elementwise work is not counted."""
        cfg, t = self.cfg, self.traffic
        with torch.device("meta"):
            ref = SegPP(cfg["variant"], cfg["nc"], cfg["ch"], cfg["task"])
            x = torch.empty(t["batch"], cfg["ch"], t["size"], t["size"])
            om = torch.empty(t["batch"], 1, t["size"] // 8, t["size"] // 8)

        def step():
            logits, _ = ref.train()(x, om)
            logits.sum().backward()
        return float(counted_flops(step))

    def release(self) -> None:
        self.trainer = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _feed(self, k: int, dtype=torch.float32):
        img, mask, om = (t.to(self.device) for t in self.batches[k])
        return ((img.float() / 255.0).permute(0, 3, 1, 2).to(dtype),
                (mask.float() / 255.0).permute(0, 3, 1, 2),
                om.permute(0, 3, 1, 2).to(dtype))

    def _reference_steps(self, dtype=torch.float32, control: str = ""):
        cfg, t = self.cfg, self.traffic
        ref = weights.build(SegPP, cfg["variant"], cfg["nc"], cfg["ch"],
                            cfg["task"], device=self.device)
        ref.load_state_dict(self.state, strict=True)
        if control:
            dtype = weights.lower_precision(ref, control)
        feeds = [self._feed(self.order[i % len(self.order)], dtype)
                 for i in range(FIRST_STEPS)]
        return ref_train.adamw_steps(ref, feeds, t["lr"], self.decay_steps,
                                     wd=t["weight_decay"], input_dtype=dtype)

    def _judge(self, prog: dict, ref: dict) -> Dict[str, float]:
        names = self.names
        grads = [n for n in names if ref["first_grad"][n] > 1e-3 * sorted(
            ref["first_grad"].values())[len(names) // 2]]
        loss_gap = max(abs(p - r) / abs(r) for p, r in
                       zip(prog["losses"], ref["losses"]))
        return {"loss_gap": loss_gap,
                "grad_gap": ref_train.leaf_gap(prog["first_grad"],
                                               ref["first_grad"], names),
                "change_gap": ref_train.leaf_gap(prog["change"],
                                                 ref["change"], grads)}

    def check(self) -> Dict[str, float]:
        prog = {"losses": [float(x) for x in self.losses],
                "first_grad": dict(zip(self.names,
                                       self.first_grad.tolist())),
                "change": dict(zip(self.names, self.change.tolist()))}
        with weights.exact_f32():
            return self._judge(prog, self._reference_steps())

    def control(self) -> Dict[str, float]:
        """The reference trained in the precision below the
        configuration's, in the program's place."""
        low = self._reference_steps(control=self.cfg["control"])
        with weights.exact_f32():
            return self._judge(low, self._reference_steps())
