"""PyTorch port: the arithmetic order of the band attention kernels (the
streamed kernels of `csrc/band_attention.cu` and the short ones of
`csrc/band_attention_short.cu`), emulated on the CPU, against the JAX
package's Pallas kernels in interpret mode.

The CUDA kernels run only on the card; what the CPU can check is their
blocking and rounding. The streamed path (both types, every band past 64
tokens) blocks a CTA's query rows in blocks of R (f32: 64, 32 or 16; bf16:
a consumer warpgroup's 64), runs the online softmax once a ring tile of
keys (f32 64, bf16 128), the running maximum in raw score units and the
probabilities exp2(s * sl2 - m * sl2) with sl2 = scale * log2(e) folded in,
the exp rounded to the I/O type for the p.v product while the f32 row sum
keeps it unrounded, the accumulator rescaled at each step, and one division
by the row sum at the end (`streamed_attention`). The short path (every
band of 64 tokens or fewer) packs whole bands to a tile and takes one pass
against the full row's maximum (`test_torch_port_short_training_bands.py`,
`test_torch_port_short_bands.py`). The TPU kernels round the exp against
the full row's maximum. `planned_attention` takes the blocking of the path
`attention_plan` gives a band. Held against `area_attention_fused` and
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
                                               area_attention_qkv_fused,
                                               attention_plan)

from .torch_threads import one_torch_thread  # noqa: F401

HD = 32
# the streamed path: keys a step of its online softmax (a ring tile) and
# query rows a block, by type
STREAM_KEYS = {torch.float32: 64, torch.bfloat16: 128}
STREAM_ROWS = {torch.float32: (64, 32, 16), torch.bfloat16: (128, 64)}
LOG2E = 1.4426950408889634


def streamed_attention(q, k, v, heads, dtype, rows, keys=None):
    """The streamed kernels' blocking on (G, N, C) f32 tensors holding
    `dtype` values: query blocks of `rows` (a bf16 CTA's consumer
    warpgroups take 64 each), the online softmax in steps of `keys` (the
    type's by default) in log2 units against a maximum kept in raw units;
    returns (G, N, C) in `dtype`."""
    g, n, c = q.shape
    keys = keys or STREAM_KEYS[dtype]
    block = min(rows, 64) if dtype == torch.bfloat16 else rows
    sl2 = torch.tensor(HD ** -0.5 * LOG2E, dtype=torch.float32)

    def split(t):                      # (G, heads, N, hd), head-major
        return t.reshape(g, n, heads, HD).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    out = torch.empty_like(qh)
    for r0 in range(0, n, block):
        qt = qh[:, :, r0:r0 + block]
        m = torch.full(qt.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, n, keys):
            s = qt @ kh[:, :, k0:k0 + keys].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s * sl2 - m_new * sl2)
            c_ = torch.exp2((m - m_new) * sl2)
            l = l * c_ + p.sum(-1, keepdim=True)
            acc = acc * c_ + p.to(dtype).float() @ vh[:, :, k0:k0 + keys]
            m = m_new
        out[:, :, r0:r0 + block] = acc / l
    return out.transpose(1, 2).reshape(g, n, c).to(dtype)


def planned_attention(q, k, v, heads, dtype):
    """Kernel C's blocking on the path `attention_plan` gives its (G, N, C)
    band: the short one's packed tiles, or the streamed one's query blocks
    and key tiles."""
    from .test_torch_port_short_training_bands import short_band_attention
    plan = attention_plan(*q.shape, dtype, projection=False)
    if plan.path == "short":
        return short_band_attention(q, k, v, heads, dtype, rows=plan.rows)
    return streamed_attention(q, k, v, heads, dtype, plan.rows)


def planned_qkv_attention(x, w, b, heads, dtype):
    """Kernel A on its planned path: the short kernels' blocking, or the
    projection (f32 accumulation, f32 bias, rounded to `dtype`) then the
    streamed blocking; returns (o, v)."""
    from .test_torch_port_short_bands import short_attention
    plan = attention_plan(*x.shape, dtype)
    if plan.path == "short":
        return short_attention(x, w, b, heads, dtype)
    c = x.shape[-1]
    qkv = (x @ w + b).to(dtype).float()
    q, k, v = qkv.split(c, -1)
    return streamed_attention(q, k, v, heads, dtype, plan.rows), v.to(dtype)


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
    """Kernel C's order on its planned path against the Pallas
    `area_attention_fused`."""
    c = HD * heads
    q, k, v = _arrays([((g, n, c), 1.0)] * 3, seed=n + heads, dtype=dtype)
    want = np.asarray(jax_fused(*(jnp.asarray(t, jdtype) for t in (q, k, v)),
                                heads).astype(jnp.float32))
    got = planned_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                            heads, dtype)
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
    """Kernel A's order on its planned path (projection, then attention)
    against the Pallas `area_attention_qkv_fused`: o, and v within one
    rounding."""
    c = HD * heads
    x, w, b = _arrays([((g, n, c), 1.0), ((c, 3 * c), 0.5 / np.sqrt(c)),
                       ((3 * c,), 0.1)], seed=n + 7 * heads, dtype=dtype)
    b = b.astype(np.float32)
    want_o, want_v = (np.asarray(t.astype(jnp.float32)) for t in jax_qkv(
        jnp.asarray(x, jdtype), jnp.asarray(w, jdtype), jnp.asarray(b)[None],
        heads))
    got_o, got_v = planned_qkv_attention(
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


STREAM_CASES = [(dtype, rows) for dtype in (torch.float32, torch.bfloat16)
                for rows in STREAM_ROWS[dtype]]


@pytest.mark.parametrize("dtype,rows", STREAM_CASES,
                         ids=[f"{str(d)[6:]}-{r}" for d, r in STREAM_CASES])
@pytest.mark.parametrize("g,n,heads", CASES)
def test_streamed_training_kernel_matches_jax(g, n, heads, dtype, rows):
    """Kernel C's streamed blocking at every query-block size against the
    Pallas `area_attention_fused`, and against the port's entry point on
    the CPU (the full-row plain version)."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    c = HD * heads
    q, k, v = _arrays([((g, n, c), 1.0)] * 3, seed=n + heads, dtype=dtype)
    want = np.asarray(jax_fused(*(jnp.asarray(t, jdtype) for t in (q, k, v)),
                                heads).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = streamed_attention(tq, tk, tv, heads, dtype, rows)
    tol = _tolerance(dtype, want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    plain = area_attention_fused(tq.to(dtype), tk.to(dtype), tv.to(dtype),
                                 heads)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("dtype,rows", STREAM_CASES,
                         ids=[f"{str(d)[6:]}-{r}" for d, r in STREAM_CASES])
@pytest.mark.parametrize("g,n,heads", CASES)
def test_streamed_eval_kernel_matches_jax(g, n, heads, dtype, rows):
    """Kernel A on the streamed path: the projection (f32 accumulation, f32
    bias, rounded to the I/O type), then the streamed blocking, against the
    Pallas `area_attention_qkv_fused`."""
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    c = HD * heads
    x, w, b = _arrays([((g, n, c), 1.0), ((c, 3 * c), 0.5 / np.sqrt(c)),
                       ((3 * c,), 0.1)], seed=n + 7 * heads, dtype=dtype)
    b = b.astype(np.float32)
    want_o = np.asarray(jax_qkv(
        jnp.asarray(x, jdtype), jnp.asarray(w, jdtype), jnp.asarray(b)[None],
        heads)[0].astype(jnp.float32))
    qkv = (torch.from_numpy(x) @ torch.from_numpy(w)
           + torch.from_numpy(b)).to(dtype).float()
    got = streamed_attention(*qkv.split(c, -1), heads, dtype, rows)
    np.testing.assert_allclose(got.float().numpy(), want_o, rtol=0,
                               atol=_tolerance(dtype, want_o))
