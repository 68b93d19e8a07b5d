"""v8-style detection + instance-segmentation training loss.

Counterpart of `yolou_tpu/losses/v8.py`: four parts [box, seg, cls, dfl]
with TAL assignment, CIoU + DFL box terms, BCE classification, and the mask
term (crop-normalised BCE plus, by default, 0.8 x one global Tversky per
image). Ground truth is padded to G rows with a validity mask, and the
positive anchors of each image are gathered to a fixed top-k set, as there.

Layouts are this package's: `raw` per-level NCHW maps, `protos`
(B, nm, Hm, Wm). Anchors are flattened in `decode_detections`' order.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.boxes import (bbox2dist, bbox_iou_aligned, dfl_decode, dist2bbox,
                         make_anchors, xywh2xyxy)
from ..ops.masks import crop_mask
from ..ops.nms import topk_stable
from ..parallel.mesh import data_size, global_sum
from .dice import bce_with_logits
from .tal import task_aligned_assign


@dataclasses.dataclass(frozen=True)
class LossHyp:
    box: float = 7.5
    cls: float = 0.5
    dfl: float = 1.5
    tversky: float = 0.8        # weight of the extra mask term
    tversky_alpha: float = 0.4
    tversky_beta: float = 0.6
    use_tversky: bool = True    # False = upstream ultralytics pure-BCE mask loss


class LossOutputs(NamedTuple):
    total: torch.Tensor
    parts: Dict[str, torch.Tensor]   # box, seg, cls, dfl (pre-gain, batch mean)


def _df_loss(pred_distri: torch.Tensor, target: torch.Tensor,
             reg_max: int) -> torch.Tensor:
    """Distribution focal loss per anchor (mean over 4 sides); target (.., 4)."""
    tl = target.floor().long()
    tr = tl + 1
    wl = tr.float() - target
    wr = 1.0 - wl
    logp = pred_distri.unflatten(-1, (4, reg_max)).log_softmax(-1)
    ce_l = -logp.gather(-1, tl[..., None])[..., 0]
    ce_r = -logp.gather(-1, tr.clamp(0, reg_max - 1)[..., None])[..., 0]
    return (ce_l * wl + ce_r * wr).mean(-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...) rows at idx (B, K) -> (B, K, ...)."""
    view = idx.reshape(idx.shape + (1,) * (x.dim() - 2))
    return x.gather(1, view.expand(-1, -1, *x.shape[2:]))


def v8_loss(
    raw: Sequence[torch.Tensor],
    mask_coefs: Optional[torch.Tensor],    # (B, A, nm) or None
    protos: Optional[torch.Tensor],        # (B, nm, Hm, Wm) or None
    targets: Dict[str, torch.Tensor],
    *,
    nc: int,
    strides: Tuple[int, ...] = (8, 16, 32),
    reg_max: int = 16,
    hyp: LossHyp = LossHyp(),
    max_pos: Optional[int] = None,
    with_masks: bool = True,
    tal_topk: int = 10,
) -> LossOutputs:
    """targets: cls (B,G) int, bboxes (B,G,4) xywh normalised to [0,1],
    valid (B,G) bool, masks (B,G,Hm,Wm) float instance masks at proto
    resolution (needed when with_masks).

    max_pos bounds the per-image positive-anchor gather of the mask term.
    None sizes it to the whole TAL budget (G * topk), so no foreground anchor
    is dropped; with a smaller cap the term is the mean over the captured
    subset.

    Under an active mesh (`parallel/mesh.py`) the batch is this rank's
    shard and the result its share: the numerators over its own images, the
    normalizers (the target-score sum, the positive-anchor count and the
    batch size b) over the global batch, all-reduced over the data group,
    so the shares of the data group sum to the global loss and its parts.
    Under a model axis the ranks of a model group hold the same shard and
    the same share."""
    b = raw[0].shape[0]
    dev = raw[0].device
    feat_shapes = tuple((r.shape[2], r.shape[3]) for r in raw)
    imgsz_h = feat_shapes[0][0] * strides[0]
    imgsz_w = feat_shapes[0][1] * strides[0]
    norm = torch.tensor([imgsz_w, imgsz_h, imgsz_w, imgsz_h],
                        dtype=torch.float32, device=dev)

    flat = torch.cat([r.flatten(2) for r in raw], 2).transpose(1, 2).float()
    pred_distri, pred_scores = flat[..., :4 * reg_max], flat[..., 4 * reg_max:]
    anchors, stride_t = make_anchors(feat_shapes, strides, 0.5, device=dev)

    # predicted boxes in feature units; image units for the assignment
    dist = dfl_decode(pred_distri, reg_max)
    pred_bboxes = dist2bbox(dist, anchors[None], xywh=False)

    gt_xyxy = xywh2xyxy(targets["bboxes"].float()) * norm           # (B,G,4) px
    assign = task_aligned_assign(
        pred_scores.detach().sigmoid(), pred_bboxes.detach() * stride_t[None],
        anchors * stride_t, targets["cls"], gt_xyxy, targets["valid"],
        topk=tal_topk)
    target_scores_sum = global_sum(assign.target_scores.sum()).clamp(min=1.0)
    fg = assign.fg_mask.float()                                     # (B,A)

    loss_cls = (bce_with_logits(pred_scores, assign.target_scores).sum()
                / target_scores_sum)

    tb_feat = assign.target_bboxes / stride_t[None]                 # feat units
    weight = assign.target_scores.sum(-1) * fg                      # (B,A)
    iou = bbox_iou_aligned(pred_bboxes, tb_feat, ciou=True)
    loss_box = ((1.0 - iou) * weight).sum() / target_scores_sum
    tdist = bbox2dist(anchors[None], tb_feat, reg_max)
    loss_dfl = ((_df_loss(pred_distri, tdist, reg_max) * weight).sum()
                / target_scores_sum)

    parts = {"box": loss_box, "cls": loss_cls, "dfl": loss_dfl,
             "seg": torch.zeros((), device=dev)}

    if with_masks and mask_coefs is not None:
        nm, hm, wm = protos.shape[1:]
        # a fixed top-kpos set of positive anchors per image; TAL assigns at
        # most tal_topk anchors per GT, so G * tal_topk covers them all
        budget = targets["valid"].shape[1] * tal_topk
        kpos = min(max_pos if max_pos is not None else budget, fg.shape[1])
        pos_score, pos_idx = topk_stable(fg * (1.0 + weight), kpos)   # (B,K)
        pos_valid = pos_score > 0.0
        coefs = _take(mask_coefs.float(), pos_idx)                  # (B,K,nm)
        gt_idx = assign.target_gt_idx.long().gather(1, pos_idx)
        tboxes = _take(assign.target_bboxes, pos_idx)               # (B,K,4) px
        pm = torch.matmul(coefs, protos.float().flatten(2)).unflatten(
            -1, (hm, wm))                                           # (B,K,Hm,Wm)
        gt_masks = _take(targets["masks"].float(), gt_idx)

        tb01 = tboxes / norm
        mxyxy = tb01 * torch.tensor([wm, hm, wm, hm], dtype=torch.float32,
                                    device=dev)
        area = ((tb01[..., 2] - tb01[..., 0]).clamp(min=0)
                * (tb01[..., 3] - tb01[..., 1]).clamp(min=0))       # (B,K)

        bce_crop = crop_mask(bce_with_logits(pm, gt_masks), mxyxy)
        bce_term = bce_crop.mean((2, 3)) / (area + 1e-8) * pos_valid

        if hyp.use_tversky:
            # one global Tversky per image over all its positive anchors,
            # added per anchor and summed: n_pos * tversky
            pv = pos_valid[..., None, None].float()
            p = pm.sigmoid() * pv
            g = gt_masks * pv
            tp = (p * g).sum((1, 2, 3))
            fp = ((1 - g) * p).sum((1, 2, 3))
            fn_ = (g * (1 - p)).sum((1, 2, 3))
            smooth = 1.0
            tv = 1.0 - (tp + smooth) / (tp + hyp.tversky_alpha * fp
                                        + hyp.tversky_beta * fn_ + smooth)
            n_pos = pos_valid.sum(1).float()
            seg_total = bce_term.sum() + (hyp.tversky * tv * n_pos).sum()
        else:
            seg_total = bce_term.sum()
        parts["seg"] = seg_total / global_sum(pos_valid.sum()).clamp(min=1.0)

    total = (parts["box"] * hyp.box + parts["seg"] * hyp.box
             + parts["cls"] * hyp.cls + parts["dfl"] * hyp.dfl) * (
                 b * data_size())
    return LossOutputs(total=total, parts=parts)
