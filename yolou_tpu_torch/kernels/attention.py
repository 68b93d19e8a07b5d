"""Band attention kernels (CUDA, sm_90a). Source: `../csrc/band_attention.cu`.

Kernel A, `area_attention_qkv_fused`: folded qkv projection + multi-head band
attention, the eval path. Replaces the TPU kernel
`yolou_tpu/ops/pallas_attn.py::area_attention_qkv_fused` (body
`_qkv_attn_kernel`).

Kernel C, `area_attention_fused` and `area_attention`: attention over given
q, k, v, the training path, differentiable. Replaces the TPU kernels
`area_attention_fused` (body `_fused_kernel`) and `area_attention` (body
`_attn_kernel`) of the same file; the second is the first with one head. As
in the JAX package only the forward is a kernel: the backward recomputes the
softmax in f32 with plain tensor operations, term for term what `_aaf_bwd`
and `_aa_bwd` do there.

Kernel A is differentiable too, as its JAX counterpart is (`_aaq_bwd`): the
backward is the plain version's VJP, autograd through
`area_attention_qkv_fused_plain` recomputed from the saved (x, w, b) with the
cotangents of both outputs, the same code on the CPU and the card. Where
grad mode is off or no input requires grad the wrapper skips autograd's
bookkeeping (the serving path calls it 8 times a forward).

Both entry points dispatch by type inside the C library: bfloat16 runs on
the tensor cores (`mma.sync` m16n8k16, a warp per 16 query rows, online
softmax over steps of 32 keys in kernel A and 64 in kernel C, probabilities
rounded to bfloat16 for the p.v product), float32 on the SIMT path (f32 FMA, which the 1e-4 comparisons
rest on). Neither falls back to the other or to the plain version.
"""

from __future__ import annotations

import torch

from . import build

HEAD_DIM = 32     # the CUDA kernel is specialised for YOLOv12's head width
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024
_CLUSTER_ROWS = 8 * 8 * 16   # bf16 kernel A: CTAs x warps x query rows


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


def smem_bytes(n: int, c: int, dtype: torch.dtype,
               projection: bool = True) -> int:
    """One CTA's dynamic shared memory in band_attention.cu (an upper bound
    on the float32 path, whose CTAs hold at most N query rows).

    bfloat16 (tensor cores): the head's keys and values, N rounded up to 16
    rows of 32 channels; kernel A also its head's (C, 96) weights in rows of
    104. float32 (SIMT): q rows, keys and values of 32 channels, N
    rounded up to 32 for keys and values; kernel A also its head's (C, 96)
    weights."""
    if dtype == torch.bfloat16:
        n_pad = -(-n // 16) * 16
        weights = 104 * c if projection else 0
        return 2 * (weights + 2 * n_pad * HEAD_DIM)
    n_pad = -(-n // 32) * 32
    elt = torch.empty((), dtype=dtype).element_size()
    weights = 3 * HEAD_DIM * c if projection else 0
    return elt * (weights + HEAD_DIM * n + 2 * HEAD_DIM * n_pad)


def max_tokens(c: int, dtype: torch.dtype, projection: bool = True) -> int:
    """The longest band the CUDA kernel takes at width C: its shared memory
    stays within a block's 227 KB, and in bfloat16 kernel A a band is one
    cluster of at most 8 CTAs of 8 warps of 16 query rows."""
    n = 0
    while _fits(n + 1, c, dtype, projection):
        n += 1
    return n


def _fits(n: int, c: int, dtype: torch.dtype, projection: bool) -> bool:
    if dtype == torch.bfloat16 and projection and n > _CLUSTER_ROWS:
        return False
    return smem_bytes(n, c, dtype, projection) <= _SMEM_LIMIT


def _check_aligned(*tensors):
    """The bfloat16 kernels read and write rows 16 bytes at a time."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the bfloat16 kernel needs 16-byte aligned tensors")


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


def _launch_qkv_attention(x, w, b, heads):
    """Launch kernel A on checked CUDA tensors; returns (o, v)."""
    g, n, c = x.shape
    if c // heads != HEAD_DIM:
        raise ValueError(f"the CUDA kernel needs head_dim {HEAD_DIM}, "
                         f"got {c // heads}")
    if not _fits(n, c, x.dtype, projection=True):
        raise ValueError(f"band of N={n}, C={c} is over the "
                         f"{max_tokens(c, x.dtype)} tokens the {x.dtype} "
                         f"kernel takes (shared memory and cluster size)")
    if x.dtype == torch.bfloat16:
        _check_aligned(x, w)
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


def _qkv_attention_forward(x, w, b, heads):
    """Kernel A on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return area_attention_qkv_fused_plain(x, w, b, heads)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _launch_qkv_attention(x, w, b, heads)


def qkv_attention_backward(x, w, b, do, dv, heads: int):
    """(dx, dw, db) of `area_attention_qkv_fused` for the cotangents `do`
    and `dv` of its two outputs: autograd through the plain version,
    recomputed from (x, w, b), which is what `jax.vjp` of the JAX package's
    `_qkv_attn_reference` computes there."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, w, b)]
        o, v = area_attention_qkv_fused_plain(*inputs, heads)
        return torch.autograd.grad((o, v), inputs, (do, dv))


class _QKVAttention(torch.autograd.Function):
    """Forward: `_qkv_attention_forward`. Backward, on both devices:
    `qkv_attention_backward`; saves x, w, b only."""

    @staticmethod
    def forward(ctx, x, w, b, heads):
        ctx.save_for_backward(x, w, b)
        ctx.heads = heads
        return _qkv_attention_forward(x, w, b, heads)

    @staticmethod
    def backward(ctx, do, dv):
        x, w, b = ctx.saved_tensors
        area_attention_qkv_fused.backward_calls += 1
        return (*qkv_attention_backward(x, w, b, do, dv, ctx.heads), None)


def area_attention_qkv_fused(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, heads: int):
    """Fused (folded qkv affine) + multi-head band attention.

    x: (G, N, C) band tokens (float32 or bfloat16); w: (C, 3C) BN-folded
    qkv weight in x.dtype with role-major output thirds, each head-major;
    b: (3C,) or (1, 3C) float32 folded bias. Returns (o, v), both (G, N, C)
    in x.dtype: o the attention output, v the value projection (it feeds
    the dw7x7 positional conv). Any N >= 1. Differentiable in x, w and b.
    """
    _check(x, w, b, heads)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad
                                    or b.requires_grad):
        return _QKVAttention.apply(x, w, b, heads)
    return _qkv_attention_forward(x, w, b, heads)


area_attention_qkv_fused.launches = 0
area_attention_qkv_fused.backward_calls = 0


# ------------------------------------------------------------- kernel C

def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(G, N, C) head-major channels -> (G, heads, N, hd)."""
    g, n, c = t.shape
    return t.reshape(g, n, heads, c // heads).transpose(1, 2)


def area_attention_fused_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain PyTorch version, the math of the JAX package's
    `area_attention_fused_reference`: per head softmax(q k^T / sqrt(hd)) in
    f32, probabilities rounded to v.dtype, p.v accumulated in f32, heads
    concatenated back to C. Differentiable by autograd."""
    g, n, c = q.shape
    hd = c // heads
    s = torch.matmul(_heads_view(q, heads).float(),
                     _heads_view(k, heads).float().transpose(-1, -2)) * hd ** -0.5
    p = s.softmax(-1).to(v.dtype).float()
    o = torch.matmul(p, _heads_view(v, heads).float())
    return o.transpose(1, 2).reshape(g, n, c).to(q.dtype)


def area_attention_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Plain single-head version over (G, N, hd), the math of the JAX
    package's `area_attention_reference`."""
    return area_attention_fused_plain(q, k, v, 1)


def _check_qkv(q, k, v, heads):
    if q.dim() != 3:
        raise ValueError(f"q must be (G, N, C), got {tuple(q.shape)}")
    g, n, c = q.shape
    if heads <= 0 or c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (k.shape == v.shape == q.shape):
        raise ValueError(f"q, k and v must share a shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return g, n, c


def _launch_band_attention(q, k, v, heads):
    """Launch kernel C on contiguous CUDA tensors; returns o."""
    g, n, c = q.shape
    if c // heads != HEAD_DIM:
        raise ValueError(f"the CUDA kernel needs head_dim {HEAD_DIM}, "
                         f"got {c // heads}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not _fits(n, c, q.dtype, projection=False):
        raise ValueError(f"band of N={n} is over the "
                         f"{max_tokens(c, q.dtype, projection=False)} tokens "
                         f"the {q.dtype} kernel's shared memory holds")
    if q.dtype == torch.bfloat16:
        _check_aligned(q, k, v)
    lib = build.load()
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.yolou_band_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g, n, c,
            heads, _DTYPE_CODE[q.dtype], stream)
    build.check(lib, code, "band attention (training) kernel")
    return o


def attention_backward(q, k, v, do, heads: int):
    """(dq, dk, dv) of `area_attention_fused` for the cotangent `do`: scores
    and softmax recomputed in f32, ds = p * (dp - sum(dp * p)), results cast
    to the inputs' types."""
    g, n, c = q.shape
    scale = (c // heads) ** -0.5
    qh, kh, vh, doh = (_heads_view(t, heads).float() for t in (q, k, v, do))
    p = (torch.matmul(qh, kh.transpose(-1, -2)) * scale).softmax(-1)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale

    def back(t, ref):
        return t.transpose(1, 2).reshape(g, n, c).to(ref.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


class _BandAttention(torch.autograd.Function):
    """Forward: kernel C on a CUDA tensor (counted on `wrapper`, the public
    function called), the plain version on a CPU tensor. Backward, on both:
    `attention_backward`; saves q, k, v only."""

    @staticmethod
    def forward(ctx, q, k, v, heads, wrapper):
        _check_qkv(q, k, v, heads)
        if q.device.type == "cpu":
            o = area_attention_fused_plain(q, k, v, heads)
        elif q.device.type == "cuda":
            o = _launch_band_attention(q, k, v, heads)
            wrapper.launches += 1
        else:
            raise RuntimeError(f"no kernel for device {q.device}")
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.wrapper = heads, wrapper
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        ctx.wrapper.backward_calls += 1
        return (*attention_backward(q, k, v, do, ctx.heads), None, None)


def area_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Multi-head softmax attention over (G, N, C) bands, C = heads * hd with
    head-major channels (channel = h * hd + d): per head
    softmax(q_h k_h^T / sqrt(hd)) v_h, outputs concatenated back to C.
    float32 or bfloat16, contiguous, any N >= 1. Differentiable."""
    return _BandAttention.apply(q, k, v, heads, area_attention_fused)


def area_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Single-head softmax attention over (G, N, hd) bands: the same kernel
    with heads = 1. Differentiable."""
    return _BandAttention.apply(q, k, v, 1, area_attention)


for _fn in (area_attention_fused, area_attention):
    _fn.launches = 0         # forward kernel launches
    _fn.backward_calls = 0   # calls of the backward
