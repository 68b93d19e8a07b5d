"""Batched fixed-shape non-max suppression on torch tensors.

Counterpart of `yolou_tpu/ops/nms.py::non_max_suppression`: confidence gate,
top-k candidates, xywh -> xyxy, per-class box offset, then suppression —
``greedy`` (exact greedy keep-set; kernel B, `kernels/nms.py`) or ``matrix``
(Fast-NMS: upper-triangular max-IoU test) — and results padded to
``max_det`` with a validity mask.

Candidate order follows `jax.lax.top_k`: descending score, equal scores in
index order. `torch.topk` promises no order among ties, so a stable sort is
used; a different order among tied candidates would change greedy keep-sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..kernels.nms import suppress_greedy
from .boxes import box_iou, xywh2xyxy


class NMSResult(NamedTuple):
    """Padded detections: boxes xyxy, conf, cls, extra (mask coefs), valid."""

    boxes: torch.Tensor   # (B, max_det, 4) xyxy
    conf: torch.Tensor    # (B, max_det)
    cls: torch.Tensor     # (B, max_det) float class index
    extra: torch.Tensor   # (B, max_det, E) mask coefficients
    valid: torch.Tensor   # (B, max_det) bool


def topk_stable(x: torch.Tensor, k: int):
    """Largest k along the last dim, ties in index order (jax.lax.top_k)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def suppress_matrix(iou: torch.Tensor, valid: torch.Tensor,
                    iou_thres: float) -> torch.Tensor:
    """Fast-NMS: keep i iff no earlier valid candidate overlaps it > thres."""
    upper = torch.triu(iou, diagonal=1) * valid[..., :, None]
    return valid & (upper.max(-2).values <= iou_thres)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, E) rows at idx (B, M) -> (B, M, E)."""
    return x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))


def non_max_suppression(prediction: torch.Tensor, conf_thres: float = 0.25,
                        iou_thres: float = 0.45, max_det: int = 300,
                        nc: int = 0, top_k: int = 512, max_wh: float = 7680.0,
                        agnostic: bool = False,
                        method: str = "greedy") -> NMSResult:
    """Batched NMS over decoded predictions (B, N, 4+nc+E), boxes xywh."""
    if method not in ("greedy", "matrix"):
        raise ValueError(f"unknown NMS method {method!r}")
    b, n, no = prediction.shape
    nc = nc or (no - 4)
    k = min(top_k, n)
    cls_scores = prediction[..., 4:4 + nc]
    conf = cls_scores[..., 0] if nc == 1 else cls_scores.max(-1).values
    score = torch.where(conf > conf_thres, conf, -1.0)
    score_k, idx = topk_stable(score, k)
    valid = score_k > 0.0
    boxes_k = xywh2xyxy(_take(prediction[..., :4], idx))
    if agnostic or nc == 1:    # class offset is identically zero
        iou_boxes = boxes_k
    else:
        cls_k = cls_scores.argmax(-1).gather(1, idx).float()
        iou_boxes = boxes_k + (cls_k * max_wh)[..., None]
    if method == "matrix":
        keep = suppress_matrix(box_iou(iou_boxes, iou_boxes), valid, iou_thres)
    else:
        keep = suppress_greedy(iou_boxes.contiguous(), valid, iou_thres)
    kept_score = torch.where(keep, score_k, -1.0)
    md = min(max_det, k)
    final_score, sel = topk_stable(kept_score, md)
    fvalid = final_score > 0.0
    z = fvalid.to(prediction.dtype)
    orig = idx.gather(1, sel)                       # rows in the original N
    if nc == 1:
        cls_f = torch.zeros_like(z)
    else:
        cls_f = cls_scores.argmax(-1).gather(1, orig).to(prediction.dtype)
    res = NMSResult(
        boxes=_take(boxes_k, sel) * z[..., None],
        conf=torch.where(fvalid, score_k.gather(1, sel), 0.0),
        cls=cls_f * z,
        extra=_take(prediction[..., 4 + nc:], orig) * z[..., None],
        valid=fvalid,
    )
    if md < max_det:
        pad = max_det - md
        res = NMSResult(
            boxes=F.pad(res.boxes, (0, 0, 0, pad)),
            conf=F.pad(res.conf, (0, pad)),
            cls=F.pad(res.cls, (0, pad)),
            extra=F.pad(res.extra, (0, 0, 0, pad)),
            valid=F.pad(res.valid, (0, pad)),
        )
    return res
