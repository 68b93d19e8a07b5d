"""PyTorch port: the arithmetic order of the tensor-core band attention
kernels (`csrc/attention_mma.cuh`), emulated on the CPU, against the JAX
package's Pallas kernels in interpret mode.

The CUDA kernels run only on the card; what the CPU can check is their
blocking and rounding. `tiled_attention` repeats it step for step: 16-row
query tiles, key steps of KT (64 for kernel C, 32 for kernel A), scores and
a running row maximum in f32, the exp against that running maximum rounded
to the I/O type for the p.v product while the f32 row sum keeps it
unrounded, the accumulator rescaled at each step, and one division by the
row sum at the end. The TPU kernels instead round the exp against the full
row's maximum. Held against `area_attention_fused` and
`area_attention_qkv_fused` (interpret mode) at N = 1, 17, 25 and 400, one
to four heads:
  * float32: within 1e-5 (the same function, f32 sums in another order);
  * bfloat16: within 2**-6 of the output's largest magnitude, i.e. two bf16
    steps at that magnitude: a probability rounded against another maximum
    moves by at most one bf16 step (2**-8 relative), the output's own
    rounding by at most one more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import area_attention_fused as jax_fused
from yolou_tpu.ops.pallas_attn import area_attention_qkv_fused as jax_qkv
from yolou_tpu_torch.kernels.attention import (area_attention_fused,
                                               area_attention_qkv_fused)

HD = 32
TILE = 16          # query rows per warp
KT_ATTN, KT_QKV = 64, 32   # keys per online-softmax step, kernels C and A


def tiled_attention(q, k, v, heads, kt, dtype):
    """The kernels' blocking on (G, N, C) f32 tensors holding `dtype`
    values; returns (G, N, C) in `dtype`."""
    g, n, c = q.shape
    scale = HD ** -0.5

    def split(t):                      # (G, heads, N, hd), head-major
        return t.reshape(g, n, heads, HD).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    out = torch.empty_like(qh)
    for r0 in range(0, n, TILE):
        qt = qh[:, :, r0:r0 + TILE]
        m = torch.full(qt.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, n, kt):
            s = qt @ kh[:, :, k0:k0 + kt].transpose(-1, -2) * scale
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            c_ = torch.exp(m - m_new)
            l = l * c_ + p.sum(-1, keepdim=True)
            acc = acc * c_ + p.to(dtype).float() @ vh[:, :, k0:k0 + kt]
            m = m_new
        out[:, :, r0:r0 + TILE] = acc / l
    return out.transpose(1, 2).reshape(g, n, c).to(dtype)


def tiled_qkv_attention(x, w, b, heads, dtype):
    """Kernel A: the projection (f32 accumulation, f32 bias, rounded to
    `dtype`), then `tiled_attention` with its key step; returns (o, v)."""
    c = x.shape[-1]
    qkv = (x @ w + b).to(dtype).float()
    q, k, v = qkv.split(c, -1)
    return tiled_attention(q, k, v, heads, KT_QKV, dtype), v.to(dtype)


CASES = [(4, 1, 1), (3, 17, 2), (2, 25, 4), (1, 400, 2)]   # G, N, heads
DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


def _arrays(shapes, seed, dtype):
    """Seeded normal arrays, rounded to `dtype`, as f32 numpy arrays."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, std, shape).astype(np.float32))
            .to(dtype).float().numpy() for shape, std in shapes]


def _tolerance(dtype, want):
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -6 * float(np.abs(want).max())


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n,heads", CASES)
def test_training_kernel_order_matches_jax(g, n, heads, name, dtype, jdtype):
    """Kernel C's order against the Pallas `area_attention_fused`."""
    c = HD * heads
    q, k, v = _arrays([((g, n, c), 1.0)] * 3, seed=n + heads, dtype=dtype)
    want = np.asarray(jax_fused(*(jnp.asarray(t, jdtype) for t in (q, k, v)),
                                heads).astype(jnp.float32))
    got = tiled_attention(*(torch.from_numpy(t) for t in (q, k, v)), heads,
                          KT_ATTN, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=_tolerance(dtype, want))
    # the port's entry point on the CPU (the full-row plain version)
    plain = area_attention_fused(*(torch.from_numpy(t).to(dtype)
                                   for t in (q, k, v)), heads)
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(),
                               rtol=0, atol=_tolerance(dtype, want))


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n,heads", CASES)
def test_eval_kernel_order_matches_jax(g, n, heads, name, dtype, jdtype):
    """Kernel A's order (projection, then attention) against the Pallas
    `area_attention_qkv_fused`: o, and v within one rounding."""
    c = HD * heads
    x, w, b = _arrays([((g, n, c), 1.0), ((c, 3 * c), 0.5 / np.sqrt(c)),
                       ((3 * c,), 0.1)], seed=n + 7 * heads, dtype=dtype)
    b = b.astype(np.float32)
    want_o, want_v = (np.asarray(t.astype(jnp.float32)) for t in jax_qkv(
        jnp.asarray(x, jdtype), jnp.asarray(w, jdtype), jnp.asarray(b)[None],
        heads))
    got_o, got_v = tiled_qkv_attention(
        *(torch.from_numpy(t) for t in (x, w, b)), heads, dtype)
    tol = _tolerance(dtype, want_o)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=0, atol=tol)
    # v: one rounding of an f32 dot product summed in another order
    v_tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * np.abs(want_v).max()
    np.testing.assert_allclose(got_v.float().numpy(), want_v, rtol=0,
                               atol=v_tol)
    plain_o, _ = area_attention_qkv_fused(
        torch.from_numpy(x).to(dtype), torch.from_numpy(w).to(dtype),
        torch.from_numpy(b), heads)
    np.testing.assert_allclose(plain_o.float().numpy(), got_o.float().numpy(),
                               rtol=0, atol=tol)
