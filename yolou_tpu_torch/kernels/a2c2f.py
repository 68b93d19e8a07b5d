"""Whole-A2C2f block kernel (CUDA, sm_90a). Source: `../csrc/a2c2f.cu`.

`a2c2f_fused` runs a full A2C2f attention block at eval (BatchNorm folded
into affine GEMMs) in one launch: cv1 -> n stages of two ABlocks (qkv, band
attention, depthwise 7x7 positional term, projection, MLP, residuals) -> cv2
over the concatenated stage outputs. Replaces the TPU kernel
`yolou_tpu/ops/pallas_a2c2f.py::a2c2f_fused` (body `_a2c2f_kernel`). The
residual-gamma form of A2C2f is not supported there and is not here.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch
import torch.nn.functional as F

from . import build
from .attention import _DTYPE_CODE, _SMEM_LIMIT, HEAD_DIM, _check_aligned

TILE = 16          # tokens per CTA tile of a2c2f.cu's f32 kernel (TM)
MMA_TILE_MIN = 16  # the bf16 kernel's smallest token tile
MAX_STAGES = 4     # the kernel's parameter block holds 8 ABlocks
_PER_BLOCK = 10    # tensors per ABlock in the flat weight list
# the bf16 kernel's weight ring (RING slabs of KS x (NP + 8) bf16), its
# attention partials (8 warps x PART_FLOATS f32) and its static GEMM
# descriptors, in bytes
_MMA_RING = 2 * 3 * 64 * (128 + 8)
_MMA_PARTS = 4 * 8 * (16 + 16 + 16 * HEAD_DIM)
_MMA_STATIC = 4 * 32


def a2c2f_mega_eligible(H: int, W: int, cin: int, c_: int, area: int,
                        heads: int) -> bool:
    """Static gate for routing A2C2f's eval path through `a2c2f_fused`; the
    same answers as the JAX package's gate, so both packages route alike:
    band length a multiple of 16, 640-class shapes only (at least 400
    tokens), N * c_ <= 1600 * 64 and cin <= 512."""
    n = H * W
    if n % area:
        area = 1
    nb = n // area
    return (nb % 16 == 0 and c_ % heads == 0 and n >= 400
            and n * c_ <= 1600 * 64 and cin <= 512)


def _split(weights: Sequence[torch.Tensor], n_stages: int):
    """(cv1, [ABlock tensors] * 2 n_stages, cv2) from the flat list."""
    ws = list(weights)
    blocks = [ws[2 + _PER_BLOCK * a: 2 + _PER_BLOCK * (a + 1)]
              for a in range(2 * n_stages)]
    return ws[:2], blocks, ws[-2:]


def band_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over (G, heads, nb, hd) f32 tensors that
    hold `dtype` values: the row maximum subtracted, the unnormalised exp
    rounded to `dtype` before p.v, the division by the f32 sum of the
    unrounded exp after it. Returns f32."""
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return torch.matmul(e.to(dtype).float(), v) / e.sum(-1, keepdim=True)


def a2c2f_fused_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      n_stages: int, area: int, heads: int,
                      attention=band_attention_plain) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: every GEMM
    accumulates in f32 and adds its f32 bias; y0, qkv, (o + pe), h and each t
    are rounded to x.dtype; residual adds are in f32; the attention is
    `attention(q, k, v, x.dtype)` per band and head (`band_attention_plain`;
    a test may pass an emulation of the kernel's blocking), its f32 output
    added to the f32 positional term before the rounding."""
    B, H, W, cin = x.shape
    (wcv1, bcv1), blocks, (wcv2, bcv2) = _split(weights, n_stages)
    c_ = wcv1.shape[1]
    N, dt, hd = H * W, x.dtype, c_ // heads
    nb = N // area

    def gemm(t, w, b):
        return torch.matmul(t.float(), w.float()) + b

    def heads_view(a):     # (B, N, c_) -> (B * area, heads, nb, hd) f32
        return a.reshape(B * area, nb, heads, hd).transpose(1, 2).float()

    t = F.silu(gemm(x.reshape(B, N, cin), wcv1, bcv1)).to(dt)
    ys = [t]
    for a, (wqkv, bqkv, wpe, bpe, wproj, bproj, wm1, bm1, wm2,
            bm2) in enumerate(blocks):
        q, k, v = gemm(t, wqkv, bqkv).to(dt).split(c_, -1)
        o = attention(heads_view(q), heads_view(k), heads_view(v), dt)
        o = o.transpose(1, 2).reshape(B, N, c_)
        pe = F.conv2d(v.reshape(B, H, W, c_).permute(0, 3, 1, 2).float(),
                      wpe.permute(2, 0, 1)[:, None], bpe, padding=3, groups=c_)
        pe = pe.permute(0, 2, 3, 1).reshape(B, N, c_)
        t = (t.float() + gemm((o + pe).to(dt), wproj, bproj)).to(dt)
        h = F.silu(gemm(t, wm1, bm1)).to(dt)
        t = (t.float() + gemm(h, wm2, bm2)).to(dt)
        if a % 2:
            ys.append(t)
    out = F.silu(gemm(torch.cat(ys, -1), wcv2, bcv2)).to(dt)
    return out.reshape(B, H, W, wcv2.shape[1])


def smem_bytes(cin: int, c_: int, n_stages: int, nb: int,
               dtype: torch.dtype) -> int:
    """One CTA's shared memory in a2c2f.cu. float32 (SIMT): three transposed
    f32 activation tiles, then one head's queries, keys and values of a band.
    bfloat16 (tensor cores) at its smallest layout, a token tile of 16 and
    one k/v buffer: the weight ring, one head's keys and values of a band,
    the attention partials, and the t, u and `big` bf16 tiles, rows padded
    by 16 bytes (the launch takes a larger layout where it fits)."""
    if dtype == torch.float32:
        n_pad = -(-nb // 32) * 32
        big = max(cin, 2 * c_, (n_stages + 1) * c_)
        return (4 * (TILE + 4) * (2 * c_ + big)
                + 4 * HEAD_DIM * (TILE + n_pad + 1 + n_pad))
    pad16 = lambda k: -(-k // 16) * 16
    big = max(pad16(cin), 2 * c_, (n_stages + 1) * c_)
    tiles = 2 * MMA_TILE_MIN * (2 * (c_ + 8) + big + 8)
    return (_MMA_RING + 2 * 2 * HEAD_DIM * pad16(nb) + _MMA_PARTS + tiles
            + _MMA_STATIC)


def _check(x, weights, n_stages, area, heads):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, cin), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if n_stages < 1 or len(weights) != 4 + 2 * _PER_BLOCK * n_stages:
        raise ValueError(f"{len(weights)} weight tensors do not make "
                         f"n_stages={n_stages} (want 4 + 20 * n_stages)")
    B, H, W, cin = x.shape
    if B < 1 or H * W < 1 or area < 1 or (H * W) % area:
        raise ValueError(f"H*W={H * W} tokens of B={B} images do not split "
                         f"into area={area} bands")
    if weights[0].dim() != 2:
        raise ValueError("cv1's weight must be a (cin, c_) matrix")
    c_ = weights[0].shape[1]
    if heads <= 0 or c_ % heads:
        raise ValueError(f"c_={c_} is not a multiple of heads={heads}")
    (wcv1, bcv1), blocks, (wcv2, bcv2) = _split(weights, n_stages)
    gemms = [("cv1", wcv1, bcv1, cin, c_)]
    f32 = [bcv1, bcv2]
    for a, (wqkv, bqkv, wpe, bpe, wproj, bproj, wm1, bm1, wm2,
            bm2) in enumerate(blocks):
        gemms += [(f"qkv{a}", wqkv, bqkv, c_, 3 * c_),
                  (f"proj{a}", wproj, bproj, c_, c_),
                  (f"mlp1_{a}", wm1, bm1, c_, 2 * c_),
                  (f"mlp2_{a}", wm2, bm2, 2 * c_, c_)]
        if tuple(wpe.shape) != (7, 7, c_) or bpe.numel() != c_:
            raise ValueError(f"pe{a}: weight {tuple(wpe.shape)} / bias "
                             f"{tuple(bpe.shape)}, want (7, 7, {c_}) / {c_}")
        f32 += [bqkv, wpe, bpe, bproj, bm1, bm2]
    if wcv2.dim() != 2:
        raise ValueError("cv2's weight must be a matrix")
    gemms.append(("cv2", wcv2, bcv2, (n_stages + 1) * c_, wcv2.shape[1]))
    for name, w, b, k, n in gemms:
        if tuple(w.shape) != (k, n) or b.numel() != n:
            raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, want ({k}, {n}) / {n}")
        if w.dtype != x.dtype:
            raise TypeError(f"{name}: weight is {w.dtype}, x is {x.dtype}")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("biases and the pe kernels must be float32")
    if not (x.is_contiguous() and all(w.is_contiguous() for w in weights)):
        raise ValueError("x and the weights must be contiguous")
    if any(w.device != x.device for w in weights):
        raise ValueError("x and the weights must be on one device")
    return c_, wcv2.shape[1]


def a2c2f_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                n_stages: int, area: int, heads: int) -> torch.Tensor:
    """Run a full A2C2f attention block (eval, BatchNorm folded) in one
    kernel launch.

    x: (B, H, W, cin) channels last, float32 or bfloat16. weights: flat list
    [cv1_w, cv1_b] + per ABlock [qkv_w, qkv_b, pe_w (7,7,c_), pe_b, proj_w,
    proj_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b] * (2 * n_stages) + [cv2_w,
    cv2_b]; GEMM weights are (cin_i, cout_i) matrices in x.dtype (qkv's
    output role-major q | k | v, each third head-major), biases and the pe
    kernels float32. Returns (B, H, W, c2) in x.dtype. Not differentiable,
    as its JAX counterpart defines no VJP: it raises on either device when
    grad mode is on and x or a weight requires grad.
    """
    c_, c2 = _check(x, weights, n_stages, area, heads)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *weights)):
        raise RuntimeError(
            "a2c2f_fused is not differentiable (an eval-only kernel with no "
            "backward): call it under torch.no_grad() or on tensors that do "
            "not require grad")
    if x.device.type == "cpu":
        return a2c2f_fused_plain(x, weights, n_stages, area, heads)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    B, H, W, cin = x.shape
    if c_ // heads != HEAD_DIM:
        raise ValueError(f"the CUDA kernel needs head_dim {HEAD_DIM}, "
                         f"got {c_ // heads}")
    if n_stages > MAX_STAGES:
        raise ValueError(f"the CUDA kernel takes at most {MAX_STAGES} "
                         f"stages, got {n_stages}")
    need = smem_bytes(cin, c_, n_stages, H * W // area, x.dtype)
    if need > _SMEM_LIMIT:
        raise ValueError(f"a band of {H * W // area} tokens at cin={cin}, "
                         f"c_={c_} needs {need} B of shared memory")
    if x.dtype == torch.bfloat16:   # the stencil reads its taps 16 B a time
        _check_aligned(*(blk[2] for blk in _split(weights, n_stages)[1]))
    lib = build.load()
    tokens = B * H * W
    out = torch.empty((B, H, W, c2), dtype=x.dtype, device=x.device)
    ys = torch.empty((tokens, (n_stages + 1) * c_), dtype=x.dtype,
                     device=x.device)
    qkv = torch.empty((2, tokens, 3 * c_), dtype=x.dtype, device=x.device)
    ptrs = (ctypes.c_void_p * len(weights))(*(w.data_ptr() for w in weights))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.yolou_a2c2f(x.data_ptr(), ptrs, len(weights),
                               out.data_ptr(), ys.data_ptr(), qkv.data_ptr(),
                               B, H, W, cin, c_, c2, n_stages, area, heads,
                               _DTYPE_CODE[x.dtype], stream)
    build.check(lib, code, "A2C2f block kernel")
    a2c2f_fused.launches += 1
    return out


a2c2f_fused.launches = 0
