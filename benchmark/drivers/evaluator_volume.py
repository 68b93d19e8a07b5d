"""Closed loop of whole-volume segmentation requests through
`yolou_tpu_torch.engine.evaluator.Evaluator.step`.

One client sends each request when the last one has returned. A request
is one volume: `slices` slices of `size`^2 pixels and the configuration's
channels, float32 in [0, 1], from pinned host memory. `Evaluator.step`
runs the fused pass over all of them as one batch (the frozen detector,
the decoder, NMS, the 0.5 threshold); the binary masks and the padded
detections are then copied to pinned host buffers and the card is
synchronised. `volumes` distinct volumes are made from the seed and sent
in a seeded order, round robin.

What is kept for the check: the answers of the last `kept` requests (the
masks and detections on the host, and the decoded predictions that
`step` ran NMS on, taken from the model's output by a forward hook).
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import compare, weights
from ..reference import nms as ref_nms
from ..reference.segpp import SegPP
from ..roofline import counted_flops
from . import DTYPES, ClosedLoop


class Driver(ClosedLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        n, size, ch = traffic["slices"], traffic["size"], cfg["ch"]
        self.images_per_request = n
        gen = weights.generator(seed, device, 1)
        vols = weights.smooth_noise(gen, (traffic["volumes"] * n, ch, size,
                                          size), traffic["cells"], device)
        self.order = torch.randperm(traffic["volumes"], generator=gen,
                                    device=device).tolist()
        ref = weights.build(SegPP, cfg["variant"], cfg["nc"], ch,
                            cfg["task"], device=device)
        weights.segpp_state(ref, seed, vols[:traffic["calibration_slices"]],
                            weights.Gate.of(traffic))
        self.state = weights.state_dict(ref)
        del ref
        pin = device.type == "cuda"
        self.volumes = [
            v.permute(0, 2, 3, 1).contiguous().to("cpu").pin_memory() if pin
            else v.permute(0, 2, 3, 1).contiguous()
            for v in vols.split(n)]
        del vols
        self.answers = [self._host_answer(n, size, pin)
                        for _ in range(traffic["kept"])]
        self._build_program()

    def _host_answer(self, n, size, pin) -> Dict[str, object]:
        md = self.traffic["max_det"]

        def buf(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        return {"mask": buf(n, size, size, 1), "boxes": buf(n, md, 4),
                "conf": buf(n, md), "cls": buf(n, md),
                "extra": buf(n, md, 0), "valid": buf(n, md, dtype=torch.bool),
                "volume": None, "preds": None}

    def _build_program(self):
        from yolou_tpu_torch.engine.evaluator import Evaluator
        from yolou_tpu_torch.models.segpp import build_segpp
        cfg, t = self.cfg, self.traffic
        model = build_segpp(cfg["arch"], cfg["variant"], cfg["nc"], cfg["ch"],
                            cfg["task"], use_logits=cfg["use_logits"],
                            dtype=DTYPES[cfg["dtype"]], device=self.device)
        model.load_state_dict(self.state, strict=True)
        self.evaluator = Evaluator(model, data_root="",
                                   image_size=t["size"],
                                   batch_size=t["slices"], conf=t["conf"],
                                   iou=t["iou"], max_det=t["max_det"],
                                   device=self.device)
        self._preds = None
        self._hook = model.register_forward_hook(self._capture)

    def _capture(self, module, args, output):
        self._preds = output[1].preds

    def warm(self) -> None:
        for i in range(self.traffic["warmup_requests"]):
            self.request(i)

    def request(self, i: int) -> None:
        v = self.order[i % len(self.order)]
        mask, dets = self.evaluator.step(self.volumes[v])
        ans = self.answers[i % len(self.answers)]
        ans["mask"].copy_(mask, non_blocking=True)
        for f in compare.DET_FIELDS:
            ans[f].copy_(getattr(dets, f), non_blocking=True)
        ans["volume"], ans["preds"] = v, self._preds
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flops_per_request(self) -> float:
        cfg, t = self.cfg, self.traffic
        with torch.device("meta"):
            ref = SegPP(cfg["variant"], cfg["nc"], cfg["ch"], cfg["task"])
            x = torch.empty(t["slices"], cfg["ch"], t["size"], t["size"])
        return float(counted_flops(lambda: ref.eval()(x)))

    def release(self) -> None:
        """Drop the program and everything it holds on the device but the
        kept answers."""
        self._hook.remove()
        self.evaluator = self._preds = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self):
        cfg = self.cfg
        ref = weights.build(SegPP, cfg["variant"], cfg["nc"], cfg["ch"],
                            cfg["task"], device=self.device)
        ref.load_state_dict(self.state, strict=True)
        return ref

    @torch.no_grad()
    def _judge(self, answers) -> Dict[str, float]:
        ref = self._reference()
        t = self.traffic
        flips, errs, differ = [], [], 0
        with weights.exact_f32():
            for ans in answers:
                x = self.volumes[ans["volume"]].to(self.device)
                mask, (raw, preds, _, _) = ref(x.permute(0, 3, 1, 2))
                flips.append(compare.mask_flips(ans["mask"][..., 0],
                                                mask[:, 0].cpu()))
                errs.append(compare.channel_err([(ans["preds"], preds, -1)]))
                differ += compare.dets_differ(ans, ref_nms.nms(
                    ans["preds"], self.cfg["nc"], t["conf"], t["iou"],
                    t["max_det"]))
        return {"mask_flips": max(flips), "preds_err": max(errs),
                "dets_differ": float(differ)}

    def check(self) -> Dict[str, float]:
        return self._judge([a for a in self.answers if a["volume"] is not None])

    @torch.no_grad()
    def control(self) -> Dict[str, float]:
        """The reference computed in the precision below the
        configuration's (its "control") answers each volume in the
        program's place."""
        ref = self._reference()
        dtype = weights.lower_precision(ref, self.cfg["control"])
        t = self.traffic
        answers = []
        for v in range(len(self.volumes)):
            x = self.volumes[v].to(self.device).permute(0, 3, 1, 2)
            mask, (_, preds, _, _) = ref(x.to(dtype))
            dets = ref_nms.nms(preds, self.cfg["nc"], t["conf"], t["iou"],
                               t["max_det"])
            answers.append({"mask": (mask > 0).float().permute(0, 2, 3, 1)
                            .cpu(), "volume": v, "preds": preds.float(),
                            **dets})
        del ref
        return self._judge(answers)
