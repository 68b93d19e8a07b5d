"""Segmentation losses: soft Dice (MONAI semantics), Tversky and BCE.

Counterpart of `yolou_tpu/losses/dice.py`. The decoder trainer's loss is
`soft_dice_loss` with the reference's MONAI DiceLoss configuration (sigmoid,
soft labels, one global Dice over the batch); `tversky_loss` is the
reference's TverskyLoss forward; the v8 loss takes `bce_with_logits`.
"""

from __future__ import annotations

import torch


def soft_dice_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                   sigmoid: bool = True, batch: bool = True,
                   soft_label: bool = True, squared_pred: bool = False,
                   smooth_nr: float = 1e-5, smooth_dr: float = 1e-5
                   ) -> torch.Tensor:
    """Soft Dice loss over any layout (the channel axis is reduced with the
    spatial ones), f32.

    `batch=True` folds the batch axis into the reduction: one global Dice
    instead of the mean of per-sample ones. `soft_label=True` takes
    sum(min(p, g)) as the intersection, else sum(p * g). `squared_pred`
    sums p^2 and g^2 in the denominator."""
    p = torch.sigmoid(logits.float()) if sigmoid else logits.float()
    g = targets.float()
    dims = tuple(range(0 if batch else 1, p.dim()))
    inter = (torch.minimum(p, g) if soft_label else p * g).sum(dims)
    if squared_pred:
        po, go = (p * p).sum(dims), (g * g).sum(dims)
    else:
        po, go = p.sum(dims), g.sum(dims)
    dice = (2.0 * inter + smooth_nr) / (po + go + smooth_dr)
    return (1.0 - dice).mean()


def tversky_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                 alpha: float = 0.4, beta: float = 0.6, smooth: float = 1.0,
                 apply_sigmoid: bool = True) -> torch.Tensor:
    """Global (flattened) Tversky loss: alpha weights false positives, beta
    false negatives."""
    p = torch.sigmoid(logits.float()) if apply_sigmoid else logits
    g = targets.float()
    tp = (p * g).sum()
    fp = ((1.0 - g) * p).sum()
    fn = (g * (1.0 - p)).sum()
    return 1.0 - (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, f32, no reduction."""
    z = logits.float()
    g = targets.float()
    return z.clamp(min=0) - z * g + torch.log1p(torch.exp(-z.abs()))
