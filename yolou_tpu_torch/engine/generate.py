"""Objectmap and heatmap generators over the batched detector forward.

Counterpart of `yolou_tpu/engine/generate.py`. An objectmap is the raw
stride-8 class-logit map of the detector (the last channel of the P3 head
output, no sigmoid), saved per image as `<name>_20.npy`: the decoder
trainer's conditioning input. `objectmaps_from_images` is the core over a
uint8 batch already in memory; `generate_objectmaps` reads each split's PNGs
with cv2 and saves what it returns. A heatmap is the Gaussian splat of the
predicted boxes, saved as a PNG. cv2 is imported only where files are read
or written.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.gaussian import splat_heatmaps
from .predictor import Predictor


def _split_images(data_root: str, split: str) -> List[Tuple[str, str]]:
    d = os.path.join(data_root, "images", split)
    return [(os.path.splitext(f)[0], os.path.join(d, f))
            for f in sorted(os.listdir(d))
            if f.lower().endswith((".png", ".jpg", ".jpeg"))]


def _read_images(chunk: Sequence[Tuple[str, str]],
                 gray: bool = False) -> List[np.ndarray]:
    """HWC uint8 images as stored (grayscale with `gray`, as the JAX
    predictor reads files for a one-channel model)."""
    import cv2
    flag = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_UNCHANGED
    imgs = []
    for _, path in chunk:
        img = cv2.imread(path, flag)
        imgs.append(img[..., None] if img.ndim == 2 else img)
    return imgs


def objectmaps_from_images(predictor: Predictor, imgs_u8) -> np.ndarray:
    """(b, H, W, C) uint8 -> (b, imgsz/8, imgsz/8) f32 raw class logits: the
    last channel of the stride-8 head output (NCHW here), no sigmoid."""
    out = predictor.raw_forward(imgs_u8)
    return out.raw[0][:, -1].float().cpu().numpy()


def generate_objectmaps(predictor: Predictor, data_root: str,
                        out_root: Optional[str] = None,
                        splits: Sequence[str] = ("test", "train", "val"),
                        batch_size: int = 128) -> Dict[str, int]:
    """Write `objectmap/<split>/<name>_20.npy` for every image of every
    split; returns the image count of each split."""
    out_root = out_root or data_root
    counts = {}
    for split in splits:
        entries = _split_images(data_root, split)
        out_dir = os.path.join(out_root, "objectmap", split)
        os.makedirs(out_dir, exist_ok=True)
        for start in range(0, len(entries), batch_size):
            chunk = entries[start:start + batch_size]
            maps = objectmaps_from_images(predictor,
                                          np.stack(_read_images(chunk)))
            for (name, _), m in zip(chunk, maps):
                np.save(os.path.join(out_dir, f"{name}_20.npy"), m)
        counts[split] = len(entries)
    return counts


def generate_heatmaps(predictor: Predictor, data_root: str,
                      out_root: Optional[str] = None,
                      splits: Sequence[str] = ("test", "train", "val"),
                      size: int = 160, batch_size: int = 64) -> Dict[str, int]:
    """Write `heatmap/<split>/<name>.png`: the Gaussian splat of each
    image's predicted boxes, x255 clipped to uint8."""
    import cv2

    out_root = out_root or data_root
    counts = {}
    for split in splits:
        entries = _split_images(data_root, split)
        out_dir = os.path.join(out_root, "heatmap", split)
        os.makedirs(out_dir, exist_ok=True)
        for start in range(0, len(entries), batch_size):
            chunk = entries[start:start + batch_size]
            results = predictor(_read_images(chunk,
                                             predictor.channels == 1))
            k = max(1, max(len(r.boxes) for r in results))
            bxywh = np.zeros((len(results), k, 4), np.float32)
            conf = np.zeros((len(results), k), np.float32)
            valid = np.zeros((len(results), k), bool)
            for i, r in enumerate(results):
                n = len(r.boxes)
                bxywh[i, :n] = r.boxes.xywh
                conf[i, :n] = r.boxes.conf
                valid[i, :n] = True
            canvases = splat_heatmaps(
                *(torch.from_numpy(a).to(predictor.device)
                  for a in (bxywh, conf, valid)), size=size).cpu().numpy()
            for (name, _), canvas in zip(chunk, canvases):
                png = np.clip(canvas * 255.0, 0, 255).astype(np.uint8)
                cv2.imwrite(os.path.join(out_dir, f"{name}.png"), png)
        counts[split] = len(entries)
    return counts


def spatial_confidence(logits: np.ndarray, k_frac: float = 0.20) -> float:
    """The mean of the top `k_frac` share of the sigmoid of `logits`."""
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, np.float64).reshape(-1)))
    k = max(1, int(k_frac * probs.size))
    return float(np.sort(probs)[-k:].mean())


def argmax_confidence(logits: np.ndarray) -> float:
    """The sigmoid of the largest logit."""
    return float(1.0 / (1.0 + np.exp(-float(np.max(logits)))))
