"""Composite decoder losses: focal, Hausdorff-DT and the YOLOU combination.

Counterpart of `yolou_tpu/losses/composite.py`: the loss family of the
reference's YOLOU loss (Dice 0.6 / Tversky 0.4, optionally Hausdorff-DT and
focal terms); the shipped decoder training uses plain Dice. The Hausdorff-DT
loss (Karimi & Salcudean, 2019) weights (p - g)^2 by edt(g)^alpha +
edt(p)^alpha, with the distance fields from `metrics/seg.py`'s exact
separable EDT, detached (constants to the gradient), as in MONAI.
"""

from __future__ import annotations

import torch

from ..metrics.seg import _edt_sq_2d
from .dice import soft_dice_loss, tversky_loss


def focal_loss(logits: torch.Tensor, targets: torch.Tensor, *,
               gamma: float = 2.0, alpha: float = 0.25) -> torch.Tensor:
    """Binary focal loss (mean-reduced), MONAI/torchvision convention."""
    z = logits.float()
    g = targets.float()
    p = torch.sigmoid(z)
    ce = z.clamp(min=0) - z * g + torch.log1p(torch.exp(-z.abs()))
    p_t = p * g + (1 - p) * (1 - g)
    a_t = alpha * g + (1 - alpha) * (1 - g) if alpha >= 0 else 1.0
    return torch.mean(a_t * ((1 - p_t) ** gamma) * ce)


def hausdorff_dt_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                      alpha: float = 2.0,
                      apply_sigmoid: bool = True) -> torch.Tensor:
    """Hausdorff distance-transform loss over (B, H, W, 1) or (B, H, W)
    masks (channel-last, as the JAX function takes them)."""
    p = torch.sigmoid(logits.float()) if apply_sigmoid else logits.float()
    g = targets.float()
    if p.dim() == 4:
        p, g = p[..., 0], g[..., 0]
    with torch.no_grad():
        pb, gb = p > 0.5, g > 0.5
        dp = _edt_sq_2d(pb).clamp(min=0).sqrt()
        dg = _edt_sq_2d(gb).clamp(min=0).sqrt()
        # empty masks give INF distance fields; zero them out
        dp = torch.where(pb.flatten(1).any(1)[:, None, None], dp, 0.0)
        dg = torch.where(gb.flatten(1).any(1)[:, None, None], dg, 0.0)
        dist = dp ** alpha + dg ** alpha
    return ((p - g) ** 2 * dist).mean((1, 2)).mean()


def yolou_composite_loss(logits: torch.Tensor, targets: torch.Tensor, *,
                         dice_weight: float = 0.6, tversky_weight: float = 0.4,
                         hausdorff_weight: float = 0.0,
                         focal_weight: float = 0.0) -> torch.Tensor:
    """The YOLOU loss combination (defaults 0.6 Dice + 0.4 Tversky)."""
    total = 0.0
    if dice_weight:
        total = total + dice_weight * soft_dice_loss(logits, targets)
    if tversky_weight:
        total = total + tversky_weight * tversky_loss(logits, targets)
    if hausdorff_weight:
        total = total + hausdorff_weight * hausdorff_dt_loss(logits, targets)
    if focal_weight:
        total = total + focal_weight * focal_loss(logits, targets)
    return total
