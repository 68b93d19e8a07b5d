"""PyTorch port: kernel A at bands of 64 tokens or fewer (the short path,
`csrc/band_attention_short.cu`) and the f32 k/v projection of its streamed
path (`kv_projection_f32_kernel` in `csrc/band_attention.cu`), emulated on
the CPU against the JAX package.

The CUDA kernels run only on the card; what the CPU can check is their
blocking and rounding. `short_attention` repeats the short kernels': the
bands packed P = 64 // N to a 64-row tile (the tile's last bands may be
missing: zero rows, never stored; rows past P * N zero too), the projection
in f32 plus the f32 bias rounded to the I/O type, the scores of a row
against every key of its tile with the keys of other bands masked, one
softmax pass against the full row's maximum in exp2 with the scale folded
in, the probabilities rounded to the I/O type before p.v while the f32 row
sum keeps them unrounded, the division after. `chunked_projection`
repeats the f32 projection kernel's sums: each output one chain of fused
multiply-adds over the channels in order, 32 a ring stage.

Held against the Pallas `area_attention_qkv_fused` in interpret mode and
against `_qkv_attn_reference` (the XLA composition the JAX model takes at
bands its Pallas gate refuses, N = 25 among them) at N = 1, 4, 16, 25, 33
and 64, G not a multiple of P, one to four heads and a head of 48 padded to
64 (`pad_qkv_projection`, the true scale):
  * float32: within 1e-5 (the same function, f32 sums in another order);
  * bfloat16: within 2**-6 of the output's largest magnitude, as
    `test_torch_port_attention_tiling.py` states (a probability rounded
    against another maximum moves by one bf16 step, the output's own
    rounding by one more).
The plan: every kernel A band of 64 tokens or fewer at every yolov12 n-x
width routes "short", one device kernel a call, in both types, and its
shared memory fits a block; the Python constants are the CUDA source's.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import _qkv_attn_reference
from yolou_tpu.ops.pallas_attn import area_attention_qkv_fused as jax_qkv
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels.attention import (area_attention_qkv_fused,
                                               attention_plan, cut_heads,
                                               pad_qkv_projection,
                                               short_smem_bytes)

from .test_torch_port_long_bands import SMEM_LIMIT, SWEEP
from .torch_threads import one_torch_thread  # noqa: F401

ROWS = 64          # a tile's rows
KC = 32            # channels of a ring stage
LOG2E = 1.4426950408889634


def short_attention(x, w, b, heads, dtype, scale=None):
    """The short kernels' blocking on f32 tensors holding `dtype` values:
    x (G, N, C), w (C, 3C), b (3C,); returns (o, v) (G, N, C) in `dtype`."""
    g, n, c = x.shape
    hd = c // heads
    sl2 = torch.tensor((hd ** -0.5 if scale is None else scale) * LOG2E,
                       dtype=torch.float32)
    p = ROWS // n
    tiles = -(-g // p)
    xt = torch.zeros(tiles * p, n, c)
    xt[:g] = x
    xt = torch.nn.functional.pad(xt.reshape(tiles, p * n, c),
                                 (0, 0, 0, ROWS - p * n))
    qkv = (xt @ w + b).to(dtype).float()                  # (tiles, 64, 3C)
    q, k, v = (t.reshape(tiles, ROWS, heads, hd).transpose(1, 2)
               for t in qkv.split(c, -1))
    s = q @ k.transpose(-1, -2)                           # (tiles, h, 64, 64)
    band = torch.arange(ROWS) // n
    s = s.masked_fill(band[:, None] != band[None, :], -torch.inf)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s * sl2 - m * sl2)
    o = (e.to(dtype).float() @ v) / e.sum(-1, keepdim=True)

    def rows(t):                       # (tiles, h, 64, hd) -> (G, N, C)
        t = t.transpose(1, 2).reshape(tiles, ROWS, c)[:, :p * n]
        return t.reshape(tiles * p, n, c)[:g].to(dtype)

    return rows(o), rows(v)


def chunked_projection(x, w, b):
    """k | v = x . w[:, C:] + b[C:] as the f32 projection kernel sums it:
    per output a chain of fused multiply-adds over the channels in order
    (a float64 product and sum rounded to f32 each step), KC a stage."""
    c = x.shape[-1]
    xs = x.reshape(-1, c).astype(np.float64)
    ws = w[:, c:].astype(np.float64)
    acc = np.zeros((xs.shape[0], 2 * c), np.float32)
    for k0 in range(0, c, KC):
        for ch in range(k0, min(c, k0 + KC)):
            acc = (xs[:, ch:ch + 1] * ws[ch] + acc).astype(np.float32)
    return acc + b[c:]


def _arrays(g, n, c, dtype, seed):
    """Seeded x, w, b rounded to `dtype` (b stays f32), as numpy f32."""
    rng = np.random.default_rng(seed)

    def mk(shape, std):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(dtype).float().numpy()

    x, w = mk((g, n, c), 1.0), mk((c, 3 * c), 0.5 / np.sqrt(c))
    return x, w, rng.normal(0, 0.1, (3 * c,)).astype(np.float32)


def _tolerance(dtype, want):
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -6 * float(np.abs(want).max())


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
# G, N, heads: every P from 64 (N = 1) to 1 (N = 33, 64); G not a multiple
# of P where P > 1
CASES = [(67, 1, 1), (5, 4, 2), (7, 16, 4), (5, 25, 2), (3, 33, 2),
         (3, 64, 1)]


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n,heads", CASES)
def test_short_kernel_matches_jax(g, n, heads, name, dtype, jdtype):
    """The packed-tile blocking against the Pallas kernel (interpret mode)
    and the XLA composition: o, and v within one rounding."""
    c = 32 * heads
    x, w, b = _arrays(g, n, c, dtype, seed=100 * n + heads)
    jx, jw, jb = jnp.asarray(x, jdtype), jnp.asarray(w, jdtype), \
        jnp.asarray(b)[None]
    got_o, got_v = short_attention(
        *(torch.from_numpy(t) for t in (x, w, b)), heads, dtype)
    for want_o, want_v in (jax_qkv(jx, jw, jb, heads, interpret=True),
                           _qkv_attn_reference(jx, jw, jb, heads)):
        want_o = np.asarray(want_o.astype(jnp.float32))
        want_v = np.asarray(want_v.astype(jnp.float32))
        np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=0,
                                   atol=_tolerance(dtype, want_o))
        v_tol = (1e-5 if dtype == torch.float32
                 else 2.0 ** -8 * np.abs(want_v).max())
        np.testing.assert_allclose(got_v.float().numpy(), want_v, rtol=0,
                                   atol=v_tol)


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("n", [25])
def test_short_kernel_at_a_padded_head(n, name, dtype, jdtype):
    """Two heads of 48 channels, padded to 64 by `pad_qkv_projection` and
    run with the true scale, cut back: against the JAX kernel at 48, and
    against the port's entry point on the CPU."""
    heads, hd = 2, 48
    g, c = 5, heads * hd
    x, w, b = _arrays(g, n, c, dtype, seed=n)
    tx, tw, tb = (torch.from_numpy(t) for t in (x, w, b))
    xp, wp, bp = pad_qkv_projection(tx, tw, tb, heads, 64)
    o, v = short_attention(xp, wp, bp, heads, dtype, scale=hd ** -0.5)
    got_o, got_v = cut_heads(o, heads, hd), cut_heads(v, heads, hd)
    want_o, want_v = (np.asarray(t.astype(jnp.float32)) for t in jax_qkv(
        jnp.asarray(x, jdtype), jnp.asarray(w, jdtype), jnp.asarray(b)[None],
        heads, interpret=True))
    tol = _tolerance(dtype, want_o)
    np.testing.assert_allclose(got_o.float().numpy(), want_o, rtol=0, atol=tol)
    v_tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * np.abs(want_v).max()
    np.testing.assert_allclose(got_v.float().numpy(), want_v, rtol=0,
                               atol=v_tol)
    plain_o, _ = area_attention_qkv_fused(tx.to(dtype), tw.to(dtype), tb,
                                          heads)
    np.testing.assert_allclose(plain_o.float().numpy(),
                               got_o.float().numpy(), rtol=0, atol=tol)


@pytest.mark.parametrize("g,n,c", [(4, 400, 64), (2, 65, 128), (3, 25, 96)])
def test_f32_projection_order_matches_jax(g, n, c):
    """The f32 k/v projection's sums (channels in order, 32 a stage)
    against the JAX projection (`dot_general` with f32 accumulation plus
    the bias), within 1e-5."""
    x, w, b = _arrays(g, n, c, torch.float32, seed=c)
    want = np.asarray(jax.lax.dot_general(
        jnp.asarray(x), jnp.asarray(w), (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.float32) + jnp.asarray(b))[..., c:]
    got = chunked_projection(x, w, b).reshape(g, n, 2 * c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


SHORT_BANDS = sorted({(n, c) for *_, n, c, _ in SWEEP if n <= ROWS})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_every_short_band_takes_the_short_path(dtype):
    """Every kernel A band of 64 tokens or fewer of yolov12 n-x (160^2 to
    256^2, both layers) at batch 1, 16 and 128 and at heads of 32 and 64:
    the short path, one device kernel a call, shared memory within a
    block; kernel C at those bands takes its own short form."""
    assert {n for n, _ in SHORT_BANDS} == {25, 36, 49, 64}
    assert {c for _, c in SHORT_BANDS} == {64, 128, 256, 384}
    for (n, c), batch, hd in itertools.product(SHORT_BANDS, (1, 16, 128),
                                               (32, 64)):
        g = 4 * batch
        plan = attention_plan(g, n, c, dtype, hd=hd)
        assert (plan.path, plan.launches) == ("short", 1), (n, c, batch)
        assert plan.rows in ((64,) if dtype == torch.bfloat16 or n > 32
                             else (64, 32)), (n, c, batch)
        assert plan.smem == short_smem_bytes(c, dtype, hd, plan.rows)
        assert plan.smem <= SMEM_LIMIT
        kernel_c = attention_plan(g, n, c, dtype, False, hd)
        assert kernel_c.path == "short" and kernel_c.smem == \
            short_smem_bytes(c, dtype, hd, kernel_c.rows, False)
    assert attention_plan(8, 65, 64, dtype).path != "short"


def test_the_short_path_takes_every_width():
    """No C is refused: the ring holds at most 4 stages of 32 channels, so
    the shared memory stops growing past C = 128 (the largest: f32 at heads
    of 64)."""
    for dtype, hd, rows in itertools.product(
            (torch.float32, torch.bfloat16), (32, 64), (64, 32)):
        sizes = [short_smem_bytes(c, dtype, hd, rows)
                 for c in range(hd, 4097, hd)]
        assert max(sizes) == short_smem_bytes(128, dtype, hd, rows)
        assert max(sizes) <= SMEM_LIMIT
    assert short_smem_bytes(384, torch.float32, 64) == 132_128
    assert short_smem_bytes(64, torch.bfloat16) == 29_712


def test_the_short_constants_are_the_kernels():
    """`short_smem_bytes` mirrors band_attention_short.cu: its tile rows,
    ring stage channels, stages and probability stride."""
    text = (Path(attn.__file__).parent.parent / "csrc"
            / "band_attention_short.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert (attn._SHORT_ROWS, attn._SHORT_KC, attn._SHORT_STAGES,
            attn._LDP) == tuple(constant(n) for n in (
                "SHORT_ROWS", "SHORT_KC", "SHORT_STAGES", "LDP_SHORT"))
    assert (ROWS, KC) == (attn._SHORT_ROWS, attn._SHORT_KC)


def test_the_cpu_entry_point_is_the_plain_version():
    """On the CPU the entry point runs the plain version at a short band,
    which agrees with the packed blocking."""
    g, n, heads, c = 5, 25, 2, 64
    x, w, b = _arrays(g, n, c, torch.float32, seed=3)
    tx, tw, tb = (torch.from_numpy(t) for t in (x, w, b))
    o, v = area_attention_qkv_fused(tx, tw, tb, heads)
    eo, ev = short_attention(tx, tw, tb, heads, torch.float32)
    np.testing.assert_allclose(o.numpy(), eo.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), ev.numpy(), rtol=0, atol=1e-5)
