"""Plain reference of the serving path around the forward pass: letterbox
and greedy non-max suppression, with the port's documented semantics
(written from ultralytics' `non_max_suppression`, fixed-shape as the port
runs it). Imports nothing of the program.

NMS: a candidate is a prediction whose best class score exceeds `conf`;
the `top_k` best candidates by score (ties in index order) are taken,
boxes to xyxy, offset by class * max_wh unless one class; greedy
suppression in score order, a later candidate dropped where a kept one
overlaps it with inter > iou * (union + 1e-7); the `max_det` best kept
rows, padded with zeros and `valid` False.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


def letterbox(imgs: torch.Tensor, size: int) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, C, size, size) float32 in [0, 1]: centred
    on a 114-grey square. Only the shapes that need no resize (the longer
    side already `size`) are written here."""
    b, h, w, c = imgs.shape
    if max(h, w) != size:
        raise NotImplementedError("the reference letterboxes without resize")
    top = int(round((size - h) / 2 - 0.1))
    left = int(round((size - w) / 2 - 0.1))
    x = F.pad(imgs.float(), (0, 0, left, size - w - left, top, size - h - top),
              value=PAD_VALUE)
    return (x / 255.0).permute(0, 3, 1, 2)


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def greedy_keep(boxes: np.ndarray, valid: np.ndarray, iou: float
                ) -> np.ndarray:
    """One image's keep mask over score-sorted xyxy boxes (K, 4) float32."""
    x1, y1, x2, y2 = boxes.T
    area = (x2 - x1) * (y2 - y1)
    iw = np.clip(np.minimum(x2[:, None], x2[None]) -
                 np.maximum(x1[:, None], x1[None]), 0, None)
    ih = np.clip(np.minimum(y2[:, None], y2[None]) -
                 np.maximum(y1[:, None], y1[None]), 0, None)
    inter = iw * ih
    union = area[:, None] + area[None] - inter
    hit = inter > np.float32(iou) * (union + np.float32(1e-7))
    keep = np.zeros(len(boxes), bool)
    dropped = np.zeros(len(boxes), bool)
    for i in range(len(boxes)):
        if valid[i] and not dropped[i]:
            keep[i] = True
            dropped[i + 1:] |= hit[i, i + 1:]
    return keep


def nms(preds: torch.Tensor, nc: int, conf: float = 0.25, iou: float = 0.45,
        max_det: int = 300, top_k: int = 512, max_wh: float = 7680.0
        ) -> Dict[str, torch.Tensor]:
    """Detections of (B, N, 4 + nc + E) float32 predictions, on the CPU:
    boxes (B, max_det, 4) xyxy, conf, cls, extra (B, max_det, E), valid."""
    preds = preds.float().cpu()
    b, n, _ = preds.shape
    k = min(top_k, n)
    scores = preds[..., 4:4 + nc]
    best = scores.max(-1)
    score = torch.where(best.values > conf, best.values, -1.0)
    s_sorted, order = torch.sort(score, dim=-1, descending=True, stable=True)
    s_k, idx = s_sorted[:, :k], order[:, :k]
    boxes = xywh2xyxy(preds[..., :4].gather(1, idx[..., None].expand(-1, -1, 4)))
    cls = best.indices.gather(1, idx).float()
    offset = boxes if nc == 1 else boxes + (cls * max_wh)[..., None]
    md = min(max_det, k)
    out = {"boxes": torch.zeros(b, max_det, 4), "conf": torch.zeros(b, max_det),
           "cls": torch.zeros(b, max_det),
           "extra": torch.zeros(b, max_det, preds.shape[-1] - 4 - nc),
           "valid": torch.zeros(b, max_det, dtype=torch.bool)}
    for i in range(b):
        valid = (s_k[i] > 0).numpy()
        keep = greedy_keep(offset[i].numpy(), valid, iou)
        rows = np.flatnonzero(keep)
        rows = rows[np.argsort(-s_k[i].numpy()[rows], kind="stable")][:md]
        m = len(rows)
        rows_t = torch.from_numpy(rows)
        out["boxes"][i, :m] = boxes[i, rows_t]
        out["conf"][i, :m] = s_k[i, rows_t]
        out["cls"][i, :m] = 0.0 if nc == 1 else cls[i, rows_t]
        out["extra"][i, :m] = preds[i, idx[i, rows_t], 4 + nc:]
        out["valid"][i, :m] = True
    return out
