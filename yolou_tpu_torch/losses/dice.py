"""Segmentation loss pieces; counterpart of `yolou_tpu/losses/dice.py`.

Only `bce_with_logits` so far (the v8 loss needs it); the soft Dice and
Tversky losses come with the decoder trainer.
"""

from __future__ import annotations

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy with logits, f32, no reduction."""
    z = logits.float()
    g = targets.float()
    return z.clamp(min=0) - z * g + torch.log1p(torch.exp(-z.abs()))
