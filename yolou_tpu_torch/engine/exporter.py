"""Model export: the fused inference program as a `torch.export` artifact.

Counterpart of `yolou_tpu/engine/exporter.py`. `torch.export` captures the
whole pipeline (uint8 images -> letterbox -> forward -> decode -> NMS) as
one `ExportedProgram` of ATen operators. The hand-written kernels are
`torch.library` operators (`kernels/`), so the program carries each launch
as one node: 8 of kernel A (`yolou::band_attention_qkv`) and 1 of kernel B
(`yolou::greedy_nms`) for yolov12n-seg, 0 of A and 1 of B for the yolov8
and yolo11 graphs (no area attention); the NMS loop's data-dependent end
stays inside kernel B's operator. Loading the program needs those operators
registered (`import yolou_tpu_torch.kernels`) and nothing else of the
package's Python.

Artifacts written to a directory:
  program.pt2        `torch.export.save` of the program, traced under
                     `torch.no_grad()` on the model's device: tensors the
                     program makes (pads, zeros, the NMS padding) belong to
                     that device, so it runs there
  weights.msgpack    the model's variables in the JAX package's format
                     (`tools/convert.py::jax_variables`), the file the JAX
                     exporter writes for the same weights
  meta.json          the JAX exporter's manifest; `platforms` is the device
                     type the program was traced on, `stem_s2d` false (a
                     TPU-only layout)

`ExportedModel` loads the weights into the program's module by name, so
one program serves any checkpoint of its architecture, as in JAX.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import torch
from torch import nn

from ..models.segpp import YOLOSegPP
from ..models.yolo import YOLOModel
from ..ops.letterbox import letterbox_batch
from ..ops.nms import non_max_suppression
from ..tools.convert import jax_variables, state_dict_from_jax
from ..utils.checkpoint import load_checkpoint, save_checkpoint

PROGRAM, WEIGHTS, META = "program.pt2", "weights.msgpack", "meta.json"


class InferenceProgram(nn.Module):
    """The predictor's fused program (`Predictor.infer`): uint8 NHWC images
    -> (boxes, conf, cls, valid[, mask_coefs, protos]) in the JAX layouts,
    protos NHWC."""

    def __init__(self, model: YOLOModel, conf: float, iou: float,
                 max_det: int, imgsz: int):
        super().__init__()
        self.model = model
        self.conf, self.iou, self.max_det, self.imgsz = conf, iou, max_det, imgsz

    def forward(self, imgs_u8: torch.Tensor):
        x = letterbox_batch(imgs_u8, (self.imgsz, self.imgsz))
        out = self.model(x.permute(0, 3, 1, 2))
        dets = non_max_suppression(out.preds, conf_thres=self.conf,
                                   iou_thres=self.iou, max_det=self.max_det,
                                   nc=self.model.spec.nc)
        res = (dets.boxes, dets.conf, dets.cls, dets.valid)
        if self.model.spec.task == "segment":
            res = res + (dets.extra, out.protos.permute(0, 2, 3, 1))
        return res


class SegPPProgram(nn.Module):
    """The fused YOLO-Seg++ program: one backbone pass -> detector NMS and
    the binary whole-tumour mask, (mask uint8 (B, H, W, 1), boxes, conf,
    valid)."""

    def __init__(self, model: YOLOSegPP, conf: float, iou: float,
                 max_det: int):
        super().__init__()
        self.model = model
        self.conf, self.iou, self.max_det = conf, iou, max_det

    def forward(self, imgs_u8: torch.Tensor):
        x = imgs_u8.float() / 255.0
        mask_logits, out = self.model(x.permute(0, 3, 1, 2))
        dets = non_max_suppression(out.preds, conf_thres=self.conf,
                                   iou_thres=self.iou, max_det=self.max_det,
                                   nc=self.model.spec.nc)
        mask = (torch.sigmoid(mask_logits) > 0.5).to(torch.uint8)
        return mask.permute(0, 2, 3, 1), dets.boxes, dets.conf, dets.valid


def build_inference_fn(model: YOLOModel, conf: float = 0.25,
                       iou: float = 0.45, max_det: int = 300,
                       imgsz: int = 640) -> InferenceProgram:
    """The predictor's fused program as one module (eval mode)."""
    return InferenceProgram(model.eval(), conf, iou, max_det, imgsz).eval()


def _export(program: nn.Module, in_shape, out_dir: str,
            model: nn.Module) -> str:
    """Trace `program` on a uint8 input of `in_shape` on the model's device
    and write program.pt2 and weights.msgpack; returns the device type."""
    device = next(model.parameters()).device
    example = torch.zeros(in_shape, dtype=torch.uint8, device=device)
    with torch.no_grad():
        exported = torch.export.export(program, (example,), strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(exported, os.path.join(out_dir, PROGRAM))
    save_checkpoint(os.path.join(out_dir, WEIGHTS),
                    {"variables": jax_variables(model)})
    return device.type


def _write_meta(out_dir: str, meta: Dict) -> Dict:
    with open(os.path.join(out_dir, META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def export_model(model: YOLOModel, out_dir: str, *, imgsz: int = 640,
                 batch: int = 1, channels: int = 4, conf: float = 0.25,
                 iou: float = 0.45, max_det: int = 300) -> Dict:
    """Write the fused inference program, the weights and the manifest;
    returns the manifest. The JAX exporter's arguments, but for the
    variables, the arch and the variant (the module holds them: the
    manifest names the model's own family) and `platforms` (the program is
    traced on the model's device)."""
    in_shape = (batch, imgsz, imgsz, channels)
    device = _export(build_inference_fn(model, conf, iou, max_det, imgsz),
                     in_shape, out_dir, model)
    return _write_meta(out_dir, {
        "arch": model.spec.arch, "variant": model.spec.variant,
        "task": model.spec.task,
        "nc": model.spec.nc, "imgsz": imgsz, "batch": batch,
        "channels": channels, "stem_s2d": False, "platforms": [device],
        "conf": conf, "iou": iou, "max_det": max_det,
        "input_shape": list(in_shape),
        "outputs": ["boxes", "conf", "cls", "valid"] + (
            ["mask_coefs", "protos"] if model.spec.task == "segment"
            else [])})


def export_segpp(model: YOLOSegPP, out_dir: str, *, imgsz: int = 160,
                 batch: int = 1, channels: int = 4, conf: float = 0.25,
                 iou: float = 0.45, max_det: int = 300) -> Dict:
    """Export the fused YOLO-Seg++ end-to-end program (one backbone pass ->
    detector NMS + binary whole-tumour mask); returns the manifest."""
    in_shape = (batch, imgsz, imgsz, channels)
    device = _export(SegPPProgram(model.eval(), conf, iou, max_det).eval(),
                     in_shape, out_dir, model)
    return _write_meta(out_dir, {
        "kind": "segpp", "task": "segment-e2e", "imgsz": imgsz,
        "batch": batch, "channels": channels, "platforms": [device],
        "conf": conf, "iou": iou, "max_det": max_det,
        "input_shape": list(in_shape),
        "outputs": ["mask", "boxes", "conf", "valid"]})


class ExportedModel:
    """Load and run an exported artifact directory on the device it was
    exported on."""

    def __init__(self, path: str):
        from .. import kernels  # noqa: F401  (registers the yolou:: ops)

        with open(os.path.join(path, META)) as f:
            self.meta = json.load(f)
        self.device = torch.device(self.meta["platforms"][0])
        self.program = torch.export.load(os.path.join(path, PROGRAM))
        self.module = self.program.module()
        self.variables = load_checkpoint(
            os.path.join(path, WEIGHTS))["variables"]
        sd = state_dict_from_jax(self.variables)
        self.module.load_state_dict(
            {"model." + k: v for k, v in sd.items()}, strict=True)

    def __call__(self, imgs_u8):
        x = torch.as_tensor(imgs_u8).to(self.device, torch.uint8)
        with torch.no_grad():
            return self.module(x)
