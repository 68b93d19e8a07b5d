"""Gaussian heatmap splatting of detected boxes, batched.

Counterpart of `yolou_tpu/ops/gaussian.py::splat_heatmaps`: per box a
Gaussian with sigma = 0.15 * max(w, h) (both truncated to whole pixels, as
is the centre), scaled by the box's confidence, summed onto the canvas. The
Gaussian is separable, so the sum over boxes is one batched product of the
per-box row and column profiles: (B, S, K) x (B, K, S), no (B, K, S, S)
intermediate.
"""

from __future__ import annotations

import torch


def splat_heatmaps(boxes_xywh: torch.Tensor, conf: torch.Tensor,
                   valid: torch.Tensor, size: int = 160) -> torch.Tensor:
    """boxes (B, K, 4) xywh in canvas pixels, conf (B, K), valid (B, K) ->
    (B, size, size) f32 canvases, on the boxes' device."""
    box = boxes_xywh.float()
    cx, cy = box[..., 0].floor(), box[..., 1].floor()
    sigma = 0.15 * torch.maximum(box[..., 2].floor(), box[..., 3].floor())
    inv = 1.0 / (2 * sigma.clamp(min=1e-6) ** 2)                # (B, K)
    grid = torch.arange(size, dtype=torch.float32, device=box.device)
    gx = torch.exp(-(grid - cx[..., None]) ** 2 * inv[..., None])
    gy = torch.exp(-(grid - cy[..., None]) ** 2 * inv[..., None])
    weight = conf.float() * valid.float()
    return torch.einsum("bky,bkx->byx", gy * weight[..., None], gx)
