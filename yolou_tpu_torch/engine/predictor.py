"""Predictor: sources -> letterbox -> forward -> NMS -> masks -> Results.

Counterpart of `yolou_tpu/engine/predictor.py::Predictor`. `load_source`
routes a source to (path, HWC uint8 image) pairs as the JAX package's does:
one array or a (B, H, W, C) stack, an image file, a directory (sorted), a
glob, a `.txt` list of paths, a list of paths, arrays and PIL images, a PIL
image, a video file (`path#frameN`), a network stream (`url#frameN`, at
most 32 frames), a camera index or digit string (`webcam{i}#frame{j}`) and
a screenshot (`screen`, `screen<N>`). Image files are read by
`native/image.py` (PNG without cv2), HEIC / HEIF through PIL with the
`pillow_heif` plugin. `cv2`, PIL, `mss` and `pillow_heif` are imported
inside the call that needs them, and nothing else stands in for them.
Images are bucketed by shape and run in chunks of
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
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.yolo import YOLOModel, YoloOutputs
from ..ops.boxes import scale_boxes
from ..ops.letterbox import letterbox_batch
from ..native.image import IMREAD_GRAYSCALE, IMREAD_UNCHANGED, imread
from ..ops.masks import process_mask, process_mask_native
from ..ops.nms import NMSResult, non_max_suppression
from ..ops.resize import resize_linear_cv2
from .results import Boxes, Masks, Results

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp",
            ".heic", ".heif")
VID_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif")
STREAM_SCHEMES = ("rtsp://", "rtmp://", "http://", "https://", "tcp://")

Source = Union[str, np.ndarray, Sequence[Union[str, np.ndarray]]]


def _read_video_frames(path: str, stride: int = 1
                       ) -> List[Tuple[str, np.ndarray]]:
    """Every `stride`-th frame of a video file, as `cv2.VideoCapture`
    decodes it (BGR), named `path#frameN`; a file that does not open gives
    no frame, as in the JAX package."""
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    i = 0
    while cap.isOpened():
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            frames.append((f"{path}#frame{i}", frame))
        i += 1
    cap.release()
    return frames


def _read_stream_frames(url: str, max_frames: int = 32, stride: int = 1
                        ) -> List[Tuple[str, np.ndarray]]:
    """Up to `max_frames` frames (every `stride`-th) of a network stream,
    named `url#frameN`; a finite clip, not a live loop. IOError where the
    stream does not open."""
    import cv2

    cap = cv2.VideoCapture(url)
    if not cap.isOpened():
        raise IOError(f"cannot open stream {url}")
    frames = []
    i = 0
    while len(frames) < max_frames:
        ok, frame = cap.read()
        if not ok:
            break
        if i % stride == 0:
            frames.append((f"{url}#frame{i}", frame))
        i += 1
    cap.release()
    return frames


def _read_webcam_frames(index: int, max_frames: int = 1
                        ) -> List[Tuple[str, np.ndarray]]:
    """`max_frames` frames of camera `index`, named `webcam{index}#frame{j}`.
    RuntimeError where the camera does not open or gives no frame."""
    import cv2

    cap = cv2.VideoCapture(index)
    if not cap.isOpened():
        cap.release()
        raise RuntimeError(
            f"webcam source {index!r} could not be opened (no camera device "
            f"— headless environment?); use a file/dir/URL source instead")
    frames = []
    for i in range(max_frames):
        ok, frame = cap.read()
        if not ok:
            break
        if frame.ndim == 2:
            frame = frame[..., None]
        frames.append((f"webcam{index}#frame{i}", frame))
    cap.release()
    if not frames:
        raise RuntimeError(f"webcam source {index!r} produced no frames")
    return frames


def _grab_screenshot(spec: str) -> np.ndarray:
    """A screenshot (BGR) of monitor N for "screen<N>" (the first for
    "screen"), through `mss`, or where it is absent `PIL.ImageGrab`.
    RuntimeError where neither can take one."""
    idx = int(spec[6:]) if len(spec) > 6 and spec[6:].isdigit() else 0
    try:
        import mss

        with mss.mss() as sct:
            mon = sct.monitors[idx + 1 if len(sct.monitors) > 1 else 0]
            shot = np.asarray(sct.grab(mon))[..., :3]       # BGRA -> BGR
            return np.ascontiguousarray(shot)
    except ImportError:
        pass
    try:
        from PIL import ImageGrab

        arr = np.asarray(ImageGrab.grab())
        return arr[..., ::-1].copy()                         # RGB -> BGR
    except Exception as e:
        raise RuntimeError(
            f"screenshot source {spec!r} needs `mss` or a display for "
            f"PIL.ImageGrab: {e}") from e


def _pil_array(img, channels: int) -> np.ndarray:
    """A PIL image as HWC uint8: RGBA for 4 channels or more, L for one,
    else RGB, with the colour channels reversed to cv2's BGR order."""
    mode = "RGBA" if channels >= 4 else ("L" if channels == 1 else "RGB")
    arr = np.asarray(img.convert(mode))
    if arr.ndim == 2:
        return arr[..., None]
    if arr.shape[-1] >= 3:  # RGB(A) -> BGR(A)
        arr = np.concatenate([arr[..., :3][..., ::-1], arr[..., 3:]], axis=-1)
    return arr


def _read_heic(path: str, channels: int) -> np.ndarray:
    """A HEIC / HEIF file through PIL, with the `pillow_heif` opener
    registered where it is installed; IOError where PIL cannot decode it."""
    try:
        import pillow_heif

        pillow_heif.register_heif_opener()
    except ImportError:
        pass
    from PIL import Image

    try:
        img = Image.open(path)
        img.load()
    except Exception as e:
        raise IOError(
            f"cannot decode {path}: HEIC support needs the pillow-heif "
            f"plugin ({e})") from e
    return _pil_array(img, channels)


def _is_pil(obj) -> bool:
    """Whether `obj` is a PIL image; PIL is not imported for the question
    (no PIL image exists before PIL is)."""
    image = sys.modules.get("PIL.Image")
    return image is not None and isinstance(obj, image.Image)


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
    package's order and names: `array_{i}` for arrays, `pil_{i}` for PIL
    images (`pil_0` alone), the path for files (grayscale for a one-channel
    model, else as stored), `...#frameN` for the frames of a video, stream
    or camera."""
    def read(path: str) -> np.ndarray:
        if path.lower().endswith((".heic", ".heif")):
            return _read_heic(path, channels)
        img = imread(path, IMREAD_UNCHANGED if channels != 1
                     else IMREAD_GRAYSCALE)
        return img[..., None] if img.ndim == 2 else img

    items: List[Tuple[str, np.ndarray]] = []
    if _is_pil(source):
        items.append(("pil_0", _pil_array(source, channels)))
        source = []
    if isinstance(source, bool):
        raise TypeError(f"unsupported source type: {source!r}")
    if isinstance(source, int):
        items.extend(_read_webcam_frames(source))
    elif isinstance(source, np.ndarray):
        arrs = source if source.ndim == 4 else source[None]
        items = [(f"array_{i}", a) for i, a in enumerate(arrs)]
    elif isinstance(source, str):
        low = source.lower()
        if source.isdigit():
            items.extend(_read_webcam_frames(int(source)))
        elif low.startswith(STREAM_SCHEMES):
            items.extend(_read_stream_frames(source))
        elif low.startswith("screen"):
            items.append((source, _grab_screenshot(source)))
        elif os.path.isdir(source):
            items = [(os.path.join(source, f), read(os.path.join(source, f)))
                     for f in sorted(os.listdir(source))
                     if f.lower().endswith(IMG_EXTS)]
        elif any(c in source for c in "*?["):
            items = [(f, read(f)) for f in sorted(globlib.glob(source))]
        elif source.endswith(".txt"):
            with open(source) as fh:
                items = [(p, read(p)) for p in (ln.strip() for ln in fh) if p]
        elif low.endswith(VID_EXTS):
            items.extend(_read_video_frames(source))
        else:
            items = [(source, read(source))]
    else:
        for i, s in enumerate(source):
            if isinstance(s, np.ndarray):
                items.append((f"array_{i}", s))
            elif _is_pil(s):
                items.append((f"pil_{i}", _pil_array(s, channels)))
            else:
                items.append((s, read(s)))
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
                m = (resize_linear_cv2(m, (oh, ow)) > 0.5).float()
            mask_out = Masks(m.cpu().numpy())
        if not retina:
            boxes = scale_boxes(hw, boxes, orig.shape[:2])
        data = torch.cat([boxes, conf[:, None], cls[:, None]], 1)
        return Results(orig_img=orig if self.keep_orig_images else None,
                       path=path, names=self.names,
                       boxes=Boxes(data.cpu().numpy()), masks=mask_out)
