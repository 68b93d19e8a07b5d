"""Box geometry ops on torch tensors (boxes are (..., 4), all broadcast).

Counterparts of `yolou_tpu/ops/boxes.py`.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(x: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = x.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def box_area(box: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, shape (...,)."""
    return ((box[..., 2] - box[..., 0]).clamp(min=0)
            * (box[..., 3] - box[..., 1]).clamp(min=0))


def box_iou(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: a (..., N, 4), b (..., M, 4) -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / (union + eps)


def bbox_iou_aligned(box1: torch.Tensor, box2: torch.Tensor,
                     xywh: bool = False, ciou: bool = False,
                     eps: float = 1e-7) -> torch.Tensor:
    """Elementwise IoU / CIoU of aligned, broadcastable (..., 4) boxes
    (ultralytics `bbox_iou`; CIoU's alpha carries no gradient)."""
    if xywh:
        box1, box2 = xywh2xyxy(box1), xywh2xyxy(box2)
    b1x1, b1y1, b1x2, b1y2 = box1.unbind(-1)
    b2x1, b2y1, b2x2, b2y2 = box2.unbind(-1)
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    inter = ((torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)).clamp(min=0)
             * (torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1)).clamp(min=0))
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union
    if not ciou:
        return iou
    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((b2x1 + b2x2) - (b1x1 + b1x2)) ** 2
            + ((b2y1 + b2y2) - (b1y1 + b1y2)) ** 2) / 4.0
    v = (4 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def make_anchors(feat_shapes: Sequence[Tuple[int, int]], strides: Sequence[int],
                 offset: float = 0.5, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Anchor points (feature-map units + offset), (N, 2), and per-anchor
    strides, (N, 1), levels concatenated P3..P5."""
    pts, strs = [], []
    for (h, w), s in zip(feat_shapes, strides):
        sx = torch.arange(w, dtype=torch.float32, device=device) + offset
        sy = torch.arange(h, dtype=torch.float32, device=device) + offset
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        pts.append(torch.stack([gx.reshape(-1), gy.reshape(-1)], -1))
        strs.append(torch.full((h * w, 1), float(s), dtype=torch.float32,
                               device=device))
    return torch.cat(pts, 0), torch.cat(strs, 0)


def dist2bbox(distance: torch.Tensor, anchor_points: torch.Tensor,
              xywh: bool = True) -> torch.Tensor:
    """Decode (l, t, r, b) distances about anchor points into boxes."""
    lt, rb = distance.chunk(2, -1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    if xywh:
        return torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1)
    return torch.cat([x1y1, x2y2], -1)


def bbox2dist(anchor_points: torch.Tensor, bbox: torch.Tensor,
              reg_max: int) -> torch.Tensor:
    """Inverse of dist2bbox for DFL targets: xyxy boxes -> clamped (l,t,r,b)."""
    x1y1, x2y2 = bbox.chunk(2, -1)
    d = torch.cat([anchor_points - x1y1, x2y2 - anchor_points], -1)
    return d.clamp(0, reg_max - 1 - 0.01)


def dfl_decode(pred_distri: torch.Tensor, reg_max: int = 16) -> torch.Tensor:
    """DFL distribution -> expected distance, (..., 4*reg_max) -> (..., 4):
    softmax over each side's reg_max bins, then the expectation, in f32."""
    x = pred_distri.float().unflatten(-1, (4, reg_max)).softmax(-1)
    bins = torch.arange(reg_max, dtype=torch.float32, device=x.device)
    return (x * bins).sum(-1)


def clip_boxes(boxes: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Clip xyxy boxes to an image of shape (h, w)."""
    h, w = hw
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([x1.clamp(0, w), y1.clamp(0, h),
                        x2.clamp(0, w), y2.clamp(0, h)], -1)


def scale_boxes(from_hw: Tuple[int, int], boxes: torch.Tensor,
                to_hw: Tuple[int, int], padded: bool = True) -> torch.Tensor:
    """Rescale xyxy boxes from the letterboxed `from_hw` back to `to_hw`."""
    gain = min(from_hw[0] / to_hw[0], from_hw[1] / to_hw[1])
    pad_x = round((from_hw[1] - to_hw[1] * gain) / 2 - 0.1)
    pad_y = round((from_hw[0] - to_hw[0] * gain) / 2 - 0.1)
    if padded:
        boxes = boxes - torch.tensor([pad_x, pad_y, pad_x, pad_y],
                                     dtype=boxes.dtype, device=boxes.device)
    return clip_boxes(boxes / gain, to_hw)
