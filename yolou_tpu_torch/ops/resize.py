"""Linear image resize with `jax.image.resize(..., "linear")` semantics.

Half-pixel centres, a triangle kernel widened by the scale when shrinking
(antialiasing), weights renormalised per output sample. This is not
`F.interpolate(mode="bilinear")`, which does not antialias by default and
clamps coordinates instead of renormalising. Like JAX, each resized axis is
one contraction with a (in, out) weight matrix.

`resize_linear_cv2` is the other resize the JAX package takes:
`cv2.resize(..., INTER_LINEAR)`, which the predictor applies to masks.
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


def resize_linear_cv2(x: torch.Tensor, out_hw: Tuple[int, int]
                      ) -> torch.Tensor:
    """`cv2.resize(x, (w, h), interpolation=cv2.INTER_LINEAR)` of a float32
    (..., H, W) tensor on its own device: cv2's two source taps and float32
    weights a sample (fractions taken in double, `native/image.py::
    _linear_taps`), a horizontal pass, then a vertical one. cv2's float
    path may round a product differently (it fuses or reorders them), so a
    value can differ by a float32 rounding; a mask thresholded at 0.5 keeps
    cv2's ties, where `F.interpolate`'s float scale breaks them."""
    from ..native.image import _linear_taps
    (h, w), (oh, ow) = x.shape[-2:], out_hw
    dev = x.device
    x0, x1, ax0, ax1 = (torch.from_numpy(a).to(dev) for a in
                        _linear_taps(w, ow, clamp=True, f32=False))
    y0, y1, by0, by1 = (torch.from_numpy(a).to(dev) for a in
                        _linear_taps(h, oh, clamp=False, f32=False))
    rows = x[..., x0] * ax0 + x[..., x1] * ax1
    return (rows[..., y0, :] * by0[:, None]
            + rows[..., y1, :] * by1[:, None])
