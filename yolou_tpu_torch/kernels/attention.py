"""Kernel A: qkv projection + multi-head band attention (CUDA, sm_90a).

Replaces the TPU kernel `yolou_tpu/ops/pallas_attn.py::area_attention_qkv_fused`
(body `_qkv_attn_kernel`). Source: `../csrc/band_attention.cu`.
"""

from __future__ import annotations

import torch

from . import build

HEAD_DIM = 32     # the CUDA kernel is specialised for YOLOv12's head width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024


def area_attention_qkv_fused_plain(x: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, heads: int):
    """Plain PyTorch version, the same math as the JAX package's
    `_qkv_attn_reference` + `area_attention_fused_reference`: qkv = x.w + b
    in f32, rounded to x.dtype; per head softmax(q k^T / sqrt(hd)) in f32,
    probabilities rounded to x.dtype, p.v accumulated in f32."""
    g, n, c = x.shape
    hd = c // heads
    qkv = (torch.matmul(x.float(), w.float()) + b.reshape(-1)).to(x.dtype)
    q, k, v = qkv.split(c, -1)

    def rs(t):   # (g, n, c) -> (g, heads, n, hd), head-major channels
        return t.reshape(g, n, heads, hd).transpose(1, 2).float()

    s = torch.matmul(rs(q), rs(k).transpose(-1, -2)) * hd ** -0.5
    p = s.softmax(-1).to(x.dtype).float()
    o = torch.matmul(p, rs(v)).transpose(1, 2).reshape(g, n, c)
    return o.to(x.dtype), v.contiguous()


def smem_bytes(n: int, c: int, dtype: torch.dtype) -> int:
    """Upper bound on one CTA's dynamic shared memory in band_attention.cu
    (a CTA holds at most N query rows)."""
    n_pad = -(-n // 32) * 32
    elt = torch.empty((), dtype=dtype).element_size()
    return elt * (3 * HEAD_DIM * c + HEAD_DIM * n + 2 * HEAD_DIM * n_pad)


def _check(x, w, b, heads):
    if x.dim() != 3:
        raise ValueError(f"x must be (G, N, C), got {tuple(x.shape)}")
    g, n, c = x.shape
    if heads <= 0 or c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if w.dtype != x.dtype or b.dtype != torch.float32:
        raise TypeError(f"w must be {x.dtype} and b float32, got "
                        f"{w.dtype}, {b.dtype}")
    if tuple(w.shape) != (c, 3 * c) or b.numel() != 3 * c:
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match C={c}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError("x, w and b must be on one device")
    return g, n, c


def area_attention_qkv_fused(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, heads: int):
    """Fused (folded qkv affine) + multi-head band attention.

    x: (G, N, C) band tokens (float32 or bfloat16); w: (C, 3C) BN-folded
    qkv weight in x.dtype with role-major output thirds, each head-major;
    b: (3C,) or (1, 3C) float32 folded bias. Returns (o, v), both (G, N, C)
    in x.dtype: o the attention output, v the value projection (it feeds
    the dw7x7 positional conv). Any N >= 1.
    """
    g, n, c = _check(x, w, b, heads)
    if x.device.type == "cpu":
        return area_attention_qkv_fused_plain(x, w, b, heads)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    if c // heads != HEAD_DIM:
        raise ValueError(f"the CUDA kernel needs head_dim {HEAD_DIM}, "
                         f"got {c // heads}")
    if smem_bytes(n, c, x.dtype) > _SMEM_LIMIT:
        raise ValueError(f"band of N={n}, C={c} needs "
                         f"{smem_bytes(n, c, x.dtype)} B of shared memory")
    lib = build.load()
    o = torch.empty_like(x)
    v = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.yolou_band_attention_qkv(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
            v.data_ptr(), g, n, c, heads, _DTYPE_CODE[x.dtype], stream)
    build.check(lib, code, "band attention kernel")
    area_attention_qkv_fused.launches += 1
    return o, v


area_attention_qkv_fused.launches = 0
