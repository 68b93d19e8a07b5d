"""Predictor: uint8 arrays -> letterbox -> forward -> NMS -> masks -> Results.

Counterpart of `yolou_tpu/engine/predictor.py::Predictor` for in-memory
sources: one HWC uint8 array, a (B, H, W, C) stack, or a list of arrays.
Images are bucketed by shape and run in chunks of `batch_size`; each chunk is
one letterbox + forward + NMS on the model's device. Masks are decoded for
the valid detections only, resized back to the original image on the device,
and copied to the host per image. `raw_forward` runs letterbox + forward
only, for the objectmap generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.yolo import YOLOModel, YoloOutputs
from ..ops.boxes import scale_boxes
from ..ops.letterbox import letterbox_batch
from ..ops.masks import process_mask
from ..ops.nms import NMSResult, non_max_suppression
from .results import Boxes, Masks, Results

Source = Union[np.ndarray, Sequence[np.ndarray]]


def load_arrays(source: Source, channels: int = 4
                ) -> List[Tuple[str, np.ndarray]]:
    """(name, HWC uint8 image) pairs with `channels` channels: missing
    channels are filled with the mean of the present ones, extra ones cut."""
    if isinstance(source, np.ndarray):
        arrs = source if source.ndim == 4 else source[None]
    else:
        arrs = list(source)
    items = []
    for i, img in enumerate(arrs):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] < channels:
            extra = np.repeat(img.mean(-1, keepdims=True).astype(img.dtype),
                              channels - img.shape[-1], -1)
            img = np.concatenate([img, extra], -1)
        elif img.shape[-1] > channels:
            img = img[..., :channels]
        items.append((f"array_{i}", img))
    return items


class Predictor:
    """Detect/segment predictor over a YOLOModel (in eval mode)."""

    def __init__(self, model: YOLOModel, imgsz: int = 640, channels: int = 4,
                 conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                 batch_size: int = 16, names: Optional[Dict[int, str]] = None,
                 keep_orig_images: bool = True):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.imgsz, self.channels = imgsz, channels
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self.batch_size = batch_size
        self.task = model.spec.task
        self.names = names or {i: str(i) for i in range(model.spec.nc)}
        self.keep_orig_images = keep_orig_images

    @torch.no_grad()
    def infer(self, imgs_u8: torch.Tensor) -> Tuple[NMSResult, YoloOutputs]:
        """(B, H, W, C) uint8 on the model's device -> (detections, outputs)."""
        x = letterbox_batch(imgs_u8, (self.imgsz, self.imgsz))
        out = self.model(x.permute(0, 3, 1, 2))
        dets = non_max_suppression(out.preds, conf_thres=self.conf,
                                   iou_thres=self.iou, max_det=self.max_det,
                                   nc=self.model.spec.nc)
        return dets, out

    @torch.no_grad()
    def raw_forward(self, imgs_u8) -> YoloOutputs:
        """Letterbox + forward only, no NMS (the objectmap path): (B, H, W,
        C) uint8, array or tensor -> the model's outputs on its device."""
        x = letterbox_batch(torch.as_tensor(imgs_u8).to(self.device),
                            (self.imgsz, self.imgsz))
        return self.model(x.permute(0, 3, 1, 2))

    @torch.no_grad()
    def __call__(self, source: Source) -> List[Results]:
        items = load_arrays(source, self.channels)
        buckets: Dict[Tuple[int, int], List[int]] = {}
        for idx, (_, img) in enumerate(items):
            buckets.setdefault(tuple(img.shape[:2]), []).append(idx)
        results: List[Optional[Results]] = [None] * len(items)
        for idxs in buckets.values():
            for start in range(0, len(idxs), self.batch_size):
                sel = idxs[start:start + self.batch_size]
                imgs = np.stack([items[j][1] for j in sel])
                dets, out = self.infer(torch.from_numpy(imgs).to(self.device))
                for i, j in enumerate(sel):
                    path, orig = items[j]
                    results[j] = self._build_result(path, orig, dets, out, i)
        return results

    def _build_result(self, path: str, orig: np.ndarray, dets: NMSResult,
                      out: YoloOutputs, i: int) -> Results:
        n = int(dets.valid[i].sum())        # valid rows come first
        boxes, conf, cls = dets.boxes[i, :n], dets.conf[i, :n], dets.cls[i, :n]
        mask_out = None
        if self.task == "segment":
            m = process_mask(out.protos[i].permute(1, 2, 0), dets.extra[i, :n],
                             boxes, (self.imgsz, self.imgsz))
            keep = m.sum((-2, -1)) > 0      # drop empty masks
            boxes, conf, cls, m = boxes[keep], conf[keep], cls[keep], m[keep]
            mh, mw = m.shape[-2:]
            oh, ow = orig.shape[:2]
            if m.numel() and (mh, mw) != (oh, ow):
                gain = min(mh / oh, mw / ow)
                ph = int(round((mh - oh * gain) / 2))
                pw = int(round((mw - ow * gain) / 2))
                m = m[:, ph:mh - ph or None, pw:mw - pw or None]
                m = F.interpolate(m[:, None], size=(oh, ow), mode="bilinear",
                                  align_corners=False)[:, 0]
                m = (m > 0.5).float()
            mask_out = Masks(m.cpu().numpy())
        scaled = scale_boxes((self.imgsz, self.imgsz), boxes, orig.shape[:2])
        data = torch.cat([scaled, conf[:, None], cls[:, None]], 1)
        return Results(orig_img=orig if self.keep_orig_images else None,
                       path=path, names=self.names,
                       boxes=Boxes(data.cpu().numpy()), masks=mask_out)
