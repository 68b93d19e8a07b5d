"""Linear image resize with `jax.image.resize(..., "linear")` semantics.

Half-pixel centres, a triangle kernel widened by the scale when shrinking
(antialiasing), weights renormalised per output sample. This is not
`F.interpolate(mode="bilinear")`, which does not antialias by default and
clamps coordinates instead of renormalising. Like JAX, each resized axis is
one contraction with a (in, out) weight matrix.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def linear_resize_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in_size, out_size) float32 weight matrix, computed on the CPU in the
    JAX package's order of f32 operations (`compute_weight_mat`)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    f32 = torch.float32
    sample_f = (torch.arange(out_size, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs()
    x = x / torch.tensor(kernel_scale)
    w = (1 - x).clamp(min=0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_linear(x: torch.Tensor, out_hw: Tuple[int, int],
                  dims: Sequence[int] = (-2, -1)) -> torch.Tensor:
    """Resize floating `x` along `dims` (two axes) to `out_hw`. Axes whose
    size already matches are left as they are, as in JAX."""
    for d, n in zip(dims, out_hw):
        m = x.shape[d]
        if m == n:
            continue
        w = linear_resize_weights(m, n).to(device=x.device, dtype=x.dtype)
        x = torch.matmul(x.movedim(d, -1), w).movedim(-1, d)
    return x
