"""Offline batch inference through
`yolou_tpu_torch.engine.predictor.Predictor.infer`.

Batches of `batch` uint8 images of `height` x `width` and the
configuration's channels wait in pinned host memory; one client sends the
next batch when the last has returned. A batch: upload, `Predictor.infer`
(letterbox to `imgsz`, the forward, decode, NMS), then the padded
detections (boxes, scores, classes, mask coefficients, validity) copied to
pinned host buffers and the card synchronised. `batches` distinct batches
are made from the seed (smooth noise at the scale of `cells` pixels) and
sent in a seeded order, round robin.

Kept for the check: the last `kept` batches' detections on the host, and
the decoded predictions and mask prototypes `infer` returned with them.
"""

from __future__ import annotations

from typing import Dict

import torch

from .. import compare, weights
from ..reference import nms as ref_nms
from ..reference.yolo import YOLO
from ..roofline import counted_flops
from . import DTYPES, ClosedLoop


class Driver(ClosedLoop):
    def __init__(self, cfg: dict, traffic: dict, seed: int,
                 device: torch.device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        b, ch = traffic["batch"], cfg["ch"]
        h, w, size = traffic["height"], traffic["width"], traffic["imgsz"]
        self.images_per_request = b
        gen = weights.generator(seed, device, 1)
        imgs = (weights.smooth_noise(gen, (traffic["batches"] * b, ch, h, w),
                                     traffic["cells"], device) * 255.0
                ).round_().to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        self.order = torch.randperm(traffic["batches"], generator=gen,
                                    device=device).tolist()
        ref = weights.build(YOLO, cfg["variant"], cfg["nc"], ch, cfg["task"],
                            device=device)
        weights.detector_state(ref, seed, ref_nms.letterbox(
            imgs[:traffic["calibration_images"]], size),
            weights.Gate.of(traffic))
        self.state = weights.state_dict(ref)
        del ref
        pin = device.type == "cuda"
        self.batches = [x.to("cpu").pin_memory() if pin else x
                        for x in imgs.split(b)]
        del imgs
        md = traffic["max_det"]
        nm = 32 if cfg["task"] == "segment" else 0

        def buf(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)
        self.answers = [{"boxes": buf(b, md, 4), "conf": buf(b, md),
                         "cls": buf(b, md), "extra": buf(b, md, nm),
                         "valid": buf(b, md, dtype=torch.bool),
                         "batch": None, "preds": None, "protos": None}
                        for _ in range(traffic["kept"])]
        self._build_program()

    def _build_program(self):
        from yolou_tpu_torch.engine.predictor import Predictor
        from yolou_tpu_torch.models.yolo import build_yolo
        cfg, t = self.cfg, self.traffic
        model = build_yolo(cfg["arch"], cfg["variant"], cfg["nc"], cfg["ch"],
                           cfg["task"], dtype=DTYPES[cfg["dtype"]],
                           device=self.device)
        model.load_state_dict(self.state, strict=True)
        self.predictor = Predictor(model, imgsz=t["imgsz"],
                                   channels=cfg["ch"], conf=t["conf"],
                                   iou=t["iou"], max_det=t["max_det"],
                                   batch_size=t["batch"])

    def warm(self) -> None:
        for i in range(self.traffic["warmup_requests"]):
            self.request(i)

    def request(self, i: int) -> None:
        k = self.order[i % len(self.order)]
        x = self.batches[k].to(self.device, non_blocking=True)
        dets, out = self.predictor.infer(x)
        ans = self.answers[i % len(self.answers)]
        for f in compare.DET_FIELDS:
            ans[f].copy_(getattr(dets, f), non_blocking=True)
        ans["batch"], ans["preds"], ans["protos"] = k, out.preds, out.protos
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def flops_per_request(self) -> float:
        cfg, t = self.cfg, self.traffic
        with torch.device("meta"):
            ref = YOLO(cfg["variant"], cfg["nc"], cfg["ch"], cfg["task"])
            x = torch.empty(t["batch"], cfg["ch"], t["imgsz"], t["imgsz"])
        return float(counted_flops(lambda: ref.eval()(x)))

    def release(self) -> None:
        self.predictor = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self):
        cfg = self.cfg
        ref = weights.build(YOLO, cfg["variant"], cfg["nc"], cfg["ch"],
                            cfg["task"], device=self.device)
        ref.load_state_dict(self.state, strict=True)
        return ref

    def _input(self, k: int) -> torch.Tensor:
        return ref_nms.letterbox(self.batches[k].to(self.device),
                                 self.traffic["imgsz"])

    @torch.no_grad()
    def _judge(self, answers) -> Dict[str, float]:
        ref = self._reference()
        t = self.traffic
        errs, differ = [], 0
        with weights.exact_f32():
            for ans in answers:
                _, preds, _, protos, _ = ref(self._input(ans["batch"]))
                pairs = [(ans["preds"], preds, -1)]
                if protos is not None:
                    pairs.append((ans["protos"], protos, 1))
                errs.append(compare.channel_err(pairs))
                differ += compare.dets_differ(ans, ref_nms.nms(
                    ans["preds"], self.cfg["nc"], t["conf"], t["iou"],
                    t["max_det"]))
        return {"preds_err": max(errs), "dets_differ": float(differ)}

    def check(self) -> Dict[str, float]:
        return self._judge([a for a in self.answers if a["batch"] is not None])

    @torch.no_grad()
    def control(self) -> Dict[str, float]:
        """The reference in the precision below the configuration's (its
        "control") answers each batch in the program's place."""
        ref = self._reference()
        dtype = weights.lower_precision(ref, self.cfg["control"])
        t = self.traffic
        answers = []
        for k in range(len(self.batches)):
            _, preds, _, protos, _ = ref(self._input(k).to(dtype))
            answers.append({"batch": k, "preds": preds.float(),
                            "protos": protos, **ref_nms.nms(
                                preds, self.cfg["nc"], t["conf"], t["iou"],
                                t["max_det"])})
        del ref
        return self._judge(answers)
