"""Task-Aligned Assigner, vectorised over a padded GT dimension.

Counterpart of `yolou_tpu/losses/tal.py` (ultralytics `TaskAlignedAssigner`
semantics): align metric s^alpha * CIoU^beta, centre-in-box candidate gate,
top-k per GT, an anchor claimed by several GTs goes to the one of largest
overlap, target scores normalised by each GT's best metric and overlap.
Runs under `torch.no_grad`: the assignment carries no gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_iou_aligned
from ..ops.nms import topk_stable


class AssignResult(NamedTuple):
    target_labels: torch.Tensor   # (B, A) int32
    target_bboxes: torch.Tensor   # (B, A, 4) xyxy, same units as inputs
    target_scores: torch.Tensor   # (B, A, nc) normalised soft targets
    fg_mask: torch.Tensor         # (B, A) bool
    target_gt_idx: torch.Tensor   # (B, A) int32 index into the padded GT dim


@torch.no_grad()
def task_aligned_assign(
    pred_scores: torch.Tensor,    # (B, A, nc) sigmoided class scores
    pred_bboxes: torch.Tensor,    # (B, A, 4) xyxy (image units)
    anchor_points: torch.Tensor,  # (A, 2) xy (image units)
    gt_labels: torch.Tensor,      # (B, G) int
    gt_bboxes: torch.Tensor,      # (B, G, 4) xyxy (image units)
    mask_gt: torch.Tensor,        # (B, G) bool validity of padded GT rows
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
    eps: float = 1e-9,
) -> AssignResult:
    b, a, nc = pred_scores.shape
    g = gt_labels.shape[1]
    mask_gt = mask_gt.bool()
    mask_gt_f = mask_gt.float()

    # 1. candidate anchors: centre strictly inside the GT box
    lt = anchor_points[None, None] - gt_bboxes[:, :, None, :2]
    rb = gt_bboxes[:, :, None, 2:] - anchor_points[None, None]
    mask_in_gts = torch.cat([lt, rb], -1).amin(-1) > eps            # (B,G,A)

    # 2. alignment metric, non-zero only inside the candidate gate; the gated
    # overlaps feed both the metric and the collision argmax of step 4
    gate = mask_in_gts & mask_gt[:, :, None]
    overlaps = bbox_iou_aligned(gt_bboxes[:, :, None, :],
                                pred_bboxes[:, None, :, :],
                                ciou=True).clamp(min=0)             # (B,G,A)
    overlaps = torch.where(gate, overlaps, 0.0)
    labels = gt_labels.long().clamp(0, nc - 1)
    scores_for_gt = pred_scores.transpose(1, 2).gather(
        1, labels[:, :, None].expand(-1, -1, a))                    # (B,G,A)
    align = torch.where(gate, scores_for_gt ** alpha * overlaps ** beta, 0.0)

    # 3. top-k per GT (ties, and there are many exact zeros, in index order,
    # as jax.lax.top_k breaks them). Every pick of a valid GT row counts, the
    # zero-metric ones too; an anchor picked more than once in a row drops.
    k = min(topk, a)
    _, topk_idx = topk_stable(align, k)                             # (B,G,k)
    mask_topk = torch.zeros((b, g, a), dtype=torch.float32,
                            device=align.device)
    mask_topk.scatter_add_(2, topk_idx,
                           mask_gt_f[:, :, None].expand(-1, -1, k).contiguous())
    mask_topk = torch.where(mask_topk > 1, 0.0, mask_topk)
    mask_pos = mask_topk * mask_in_gts.float() * mask_gt_f[:, :, None]

    # 4. an anchor claimed by several GTs keeps the one of largest overlap
    # (argmax takes the first maximum)
    fg_counts = mask_pos.sum(1)                                     # (B,A)
    is_max = F.one_hot(overlaps.argmax(1), g).transpose(1, 2).float()
    mask_pos = torch.where((fg_counts > 1)[:, None, :], is_max, mask_pos)
    fg_mask = mask_pos.sum(1) > 0                                   # (B,A)
    target_gt_idx = mask_pos.argmax(1)                              # (B,A)

    # 5. gather targets
    target_labels = labels.gather(1, target_gt_idx)
    target_bboxes = gt_bboxes.gather(
        1, target_gt_idx[:, :, None].expand(-1, -1, 4))
    target_scores = (F.one_hot(target_labels, nc).float()
                     * fg_mask[:, :, None])

    # 6. normalise by each GT's best align metric and overlap
    align = align * mask_pos
    pos_align = align.amax(-1, keepdim=True)                        # (B,G,1)
    pos_overlap = (overlaps * mask_pos).amax(-1, keepdim=True)
    norm = (align * pos_overlap / (pos_align + eps)).amax(1)        # (B,A)
    target_scores = target_scores * norm[:, :, None]

    return AssignResult(target_labels.int(), target_bboxes, target_scores,
                        fg_mask, target_gt_idx.int())
