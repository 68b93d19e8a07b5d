"""Mask ops: proto decode, crop, upsample — counterparts of
`yolou_tpu/ops/masks.py`. Layouts are the JAX package's: protos
(..., Hm, Wm, nm), coefficients (..., N, nm), masks (..., N, H, W); any
leading batch dims broadcast.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .resize import resize_linear


def crop_mask(masks: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Zero mask pixels outside each box; boxes (..., N, 4) xyxy in mask px."""
    h, w = masks.shape[-2:]
    r = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, :]
    c = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[:, None]
    x1, y1, x2, y2 = (boxes[..., i, None, None] for i in range(4))
    keep = (r >= x1) & (r < x2) & (c >= y1) & (c < y2)
    return masks * keep.to(masks.dtype)


def proto_decode(coefs: torch.Tensor, protos: torch.Tensor) -> torch.Tensor:
    """Mask logits (..., N, Hm, Wm) = coefs (..., N, nm) @ protos^T, in f32."""
    hm, wm, nm = protos.shape[-3:]
    flat = protos.reshape(*protos.shape[:-3], hm * wm, nm).float()
    out = torch.matmul(coefs.float(), flat.transpose(-1, -2))
    return out.unflatten(-1, (hm, wm))


def process_mask(protos: torch.Tensor, coefs: torch.Tensor,
                 boxes: torch.Tensor, img_hw: Tuple[int, int],
                 upsample: bool = True, threshold: float = 0.5) -> torch.Tensor:
    """Binary instance masks: sigmoid -> crop at proto resolution ->
    (optional) linear upsample to img_hw -> threshold. boxes are xyxy in
    input-image pixels. Returns float {0, 1}."""
    hm, wm = protos.shape[-3:-1]
    ih, iw = img_hw
    m = torch.sigmoid(proto_decode(coefs, protos))
    scale = torch.tensor([wm / iw, hm / ih, wm / iw, hm / ih],
                         dtype=boxes.dtype, device=boxes.device)
    m = crop_mask(m, boxes * scale)
    if upsample:
        m = resize_linear(m, (ih, iw))
    return (m > threshold).float()


def scale_masks(masks: torch.Tensor, to_hw: Tuple[int, int]) -> torch.Tensor:
    """Linear resize of (..., H, W) masks to to_hw (half-pixel centres)."""
    return resize_linear(masks, to_hw)
