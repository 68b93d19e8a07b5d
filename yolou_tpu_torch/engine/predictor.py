"""Predictor: sources -> letterbox -> forward -> NMS -> masks -> Results.

Counterpart of `yolou_tpu/engine/predictor.py::Predictor`. `load_source`
routes a source to (path, HWC uint8 image) pairs as the JAX package's does:
one array or a (B, H, W, C) stack, an image file, a directory (sorted), a
glob, a `.txt` list of paths, or a list of paths and arrays; files are read
by `native/image.py` (PNG without cv2). The camera, stream, screenshot,
video, PIL and HEIC routes need `cv2.VideoCapture`, PIL or `pillow_heif`
and raise by name. Images are bucketed by shape and run in chunks of
`batch_size`; each chunk is one letterbox + forward + NMS on the model's
device. Masks are decoded for the valid detections only, resized back to
the original image on the device (with `retina_masks`, made at the original
resolution from the protos, `ops/masks.py::process_mask_native`), and
copied to the host per image. `raw_forward` runs letterbox + forward only,
for the objectmap generator.
"""

from __future__ import annotations

import glob as globlib
import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..models.yolo import YOLOModel, YoloOutputs
from ..ops.boxes import scale_boxes
from ..ops.letterbox import letterbox_batch
from ..native.image import IMREAD_GRAYSCALE, IMREAD_UNCHANGED, imread
from ..ops.masks import process_mask, process_mask_native
from ..ops.nms import NMSResult, non_max_suppression
from .results import Boxes, Masks, Results

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp",
            ".heic", ".heif")
VID_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")
STREAM_SCHEMES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")

Source = Union[str, np.ndarray, Sequence[Union[str, np.ndarray]]]


def _not_ported(route: str, source, needs: str):
    return NotImplementedError(
        f"{route} source {source!r}: not ported (it needs {needs}); pass "
        f"image files, a directory, a glob, a .txt list or arrays")


def _harmonise(img: np.ndarray, channels: int) -> np.ndarray:
    """HWC with `channels` channels: missing ones are filled with the mean
    of the present ones, extra ones cut."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] < channels:
        extra = np.repeat(img.mean(-1, keepdims=True).astype(img.dtype),
                          channels - img.shape[-1], -1)
        img = np.concatenate([img, extra], -1)
    elif img.shape[-1] > channels:
        img = img[..., :channels]
    return img


def load_source(source: Source, channels: int = 4
                ) -> List[Tuple[str, np.ndarray]]:
    """(path, HWC uint8 image) pairs with `channels` channels, in the JAX
    package's order and names: `array_{i}` for arrays, the path for files
    (grayscale for a one-channel model, else as stored)."""
    def read(path: str) -> np.ndarray:
        if path.lower().endswith((".heic", ".heif")):
            raise _not_ported("HEIC", path, "PIL and pillow_heif")
        img = imread(path, IMREAD_UNCHANGED if channels != 1
                     else IMREAD_GRAYSCALE)
        return img[..., None] if img.ndim == 2 else img

    items: List[Tuple[str, np.ndarray]] = []
    if isinstance(source, bool):
        raise TypeError(f"unsupported source type: {source!r}")
    if isinstance(source, int):
        raise _not_ported("camera", source, "cv2.VideoCapture")
    if isinstance(source, np.ndarray):
        arrs = source if source.ndim == 4 else source[None]
        items = [(f"array_{i}", a) for i, a in enumerate(arrs)]
    elif isinstance(source, str):
        low = source.lower()
        if source.isdigit():
            raise _not_ported("camera", source, "cv2.VideoCapture")
        if low.startswith(STREAM_SCHEMES):
            raise _not_ported("stream", source, "cv2.VideoCapture")
        if low.startswith("screen"):
            raise _not_ported("screenshot", source, "mss or PIL.ImageGrab")
        if os.path.isdir(source):
            items = [(os.path.join(source, f), read(os.path.join(source, f)))
                     for f in sorted(os.listdir(source))
                     if f.lower().endswith(IMG_EXTS)]
        elif any(c in source for c in "*?["):
            items = [(f, read(f)) for f in sorted(globlib.glob(source))]
        elif source.endswith(".txt"):
            with open(source) as fh:
                items = [(p, read(p)) for p in (ln.strip() for ln in fh) if p]
        elif low.endswith(VID_EXTS):
            raise _not_ported("video", source, "cv2.VideoCapture")
        else:
            items = [(source, read(source))]
    elif isinstance(source, (list, tuple)):
        for i, s in enumerate(source):
            if isinstance(s, np.ndarray):
                items.append((f"array_{i}", s))
            elif isinstance(s, str):
                items.append((s, read(s)))
            else:
                raise _not_ported("PIL", type(s).__name__, "PIL")
    else:
        raise _not_ported("PIL", type(source).__name__, "PIL")
    return [(path, _harmonise(img, channels)) for path, img in items]


class Predictor:
    """Detect/segment predictor over a YOLOModel (in eval mode)."""

    def __init__(self, model: YOLOModel, imgsz: int = 640, channels: int = 4,
                 conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                 batch_size: int = 16, names: Optional[Dict[int, str]] = None,
                 keep_orig_images: bool = True, retina_masks: bool = False):
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.imgsz, self.channels = imgsz, channels
        self.conf, self.iou, self.max_det = conf, iou, max_det
        self.batch_size = batch_size
        self.task = model.spec.task
        self.names = names or {i: str(i) for i in range(model.spec.nc)}
        self.keep_orig_images = keep_orig_images
        self.retina_masks = retina_masks

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
        items = load_source(source, self.channels)
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
        hw = (self.imgsz, self.imgsz)
        retina = self.task == "segment" and self.retina_masks
        if retina:      # boxes to the original image first; masks at its size
            boxes = scale_boxes(hw, boxes, orig.shape[:2])
        if self.task == "segment":
            protos, coefs = out.protos[i].permute(1, 2, 0), dets.extra[i, :n]
            m = (process_mask_native(protos, coefs, boxes, orig.shape[:2], hw)
                 if retina else process_mask(protos, coefs, boxes, hw))
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
        if not retina:
            boxes = scale_boxes(hw, boxes, orig.shape[:2])
        data = torch.cat([boxes, conf[:, None], cls[:, None]], 1)
        return Results(orig_img=orig if self.keep_orig_images else None,
                       path=path, names=self.names,
                       boxes=Boxes(data.cpu().numpy()), masks=mask_out)
