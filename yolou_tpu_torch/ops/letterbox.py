"""Letterbox + normalize preprocessing on torch tensors.

Counterpart of `yolou_tpu/ops/letterbox.py::letterbox_batch`: an
aspect-preserving linear resize (JAX `jax.image.resize` semantics, see
`resize.py`), padding with 114 gray, /255 and a cast — in the JAX package's
NHWC layout; the caller permutes to NCHW for the model.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .resize import resize_linear


PAD_VALUE = 114.0


def letterbox_batch(imgs: torch.Tensor, new_hw: Tuple[int, int] = (640, 640)
                    ) -> torch.Tensor:
    """Letterbox a uniform batch (B, H, W, C) uint8/float -> (B, nh, nw, C)
    float32 in [0, 1]. All images of the batch share one source shape."""
    b, h, w, c = imgs.shape
    nh, nw = new_hw
    r = min(nh / h, nw / w)
    uh, uw = int(round(h * r)), int(round(w * r))
    x = imgs.float()
    if (uh, uw) != (h, w):
        x = resize_linear(x, (uh, uw), dims=(1, 2))
    top = int(round((nh - uh) / 2 - 0.1))
    left = int(round((nw - uw) / 2 - 0.1))
    out = F.pad(x, (0, 0, left, nw - uw - left, top, nh - uh - top),
                value=PAD_VALUE)
    return out / 255.0
