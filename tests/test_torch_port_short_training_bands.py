"""PyTorch port: kernel C at bands of 64 tokens or fewer (the short path of
`csrc/band_attention_short.cu` without the projection), emulated on the CPU
against the JAX package.

The CUDA kernels run only on the card; what the CPU can check is their
blocking and rounding. `short_band_attention` repeats the short kernels'
attention as kernel C runs it (`test_torch_port_short_bands.py::
short_attention` without the projection): q, k and v packed P = rows // N
whole bands to a tile of `rows` (64; float32 also 32), the tile's missing
last bands zero (never stored) and its rows past P * N zero (the kernel
zeroes them before its copies land), the scores of a row against every key
of its tile with the keys of other bands masked, one softmax pass against
the full row's maximum in exp2 with the scale folded in, the probabilities
rounded to the I/O type before p.v while the f32 row sum keeps them
unrounded, the division after.

Held against the Pallas `area_attention_fused` in interpret mode at N = 16,
32, 48 and 64 (its gate, `pallas_band_eligible`, asks N % 16 == 0), against
`area_attention_fused_reference` (the XLA composition the JAX model takes at
the bands the gate refuses) at N = 1, 4, 25 and 33, G not a multiple of P,
one to four heads; the one-head entry against the Pallas `area_attention`
and `area_attention_reference`; a head of 48 padded to 64 (`pad_heads`, the
true scale):
  * float32: within 1e-5 (the same function, f32 sums in another order);
  * bfloat16: within 2**-6 of the output's largest magnitude, as
    `test_torch_port_attention_tiling.py` states (a probability rounded
    against another maximum, or normalised before its rounding as the
    references do, moves by one bf16 step, the output's own rounding by one
    more).
The plan: every kernel C band of 64 tokens or fewer at every yolov12 n-x
width routes "short", one device kernel a call, in both types and at both
head widths, and its shared memory fits a block; the Python constants and
the C entry's arguments are the CUDA source's.
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import area_attention as jax_single
from yolou_tpu.ops.pallas_attn import area_attention_fused as jax_fused
from yolou_tpu.ops.pallas_attn import (area_attention_fused_reference,
                                       area_attention_reference)
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels import build
from yolou_tpu_torch.kernels.attention import (area_attention,
                                               area_attention_fused,
                                               attention_plan, cut_heads,
                                               pad_heads, short_smem_bytes)

from .test_torch_port_long_bands import SMEM_LIMIT, SWEEP
from .torch_threads import one_torch_thread  # noqa: F401

ROWS = 64          # a tile's rows (float32 also half of it)
LOG2E = 1.4426950408889634


def short_band_attention(q, k, v, heads, dtype, scale=None, rows=ROWS):
    """Kernel C's short blocking on (G, N, C) f32 tensors holding `dtype`
    values, tiles of `rows`; returns (G, N, C) in `dtype`."""
    g, n, c = q.shape
    hd = c // heads
    sl2 = torch.tensor((hd ** -0.5 if scale is None else scale) * LOG2E,
                       dtype=torch.float32)
    p = rows // n
    tiles = -(-g // p)

    def pack(t):        # (G, N, C) -> (tiles, heads, rows, hd)
        packed = torch.zeros(tiles * p, n, c)
        packed[:g] = t
        packed = torch.nn.functional.pad(packed.reshape(tiles, p * n, c),
                                         (0, 0, 0, rows - p * n))
        return packed.reshape(tiles, rows, heads, hd).transpose(1, 2)

    qt, kt, vt = pack(q), pack(k), pack(v)
    s = qt @ kt.transpose(-1, -2)                       # (tiles, h, R, R)
    band = torch.arange(rows) // n
    s = s.masked_fill(band[:, None] != band[None, :], -torch.inf)
    m = s.amax(-1, keepdim=True)
    e = torch.exp2(s * sl2 - m * sl2)
    o = (e.to(dtype).float() @ vt) / e.sum(-1, keepdim=True)
    o = o.transpose(1, 2).reshape(tiles, rows, c)[:, :p * n]
    return o.reshape(tiles * p, n, c)[:g].to(dtype)


def _arrays(g, n, c, dtype, seed):
    """Seeded q, k, v rounded to `dtype`, as numpy f32."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, (g, n, c)).astype(np.float32)
                             ).to(dtype).float().numpy() for _ in range(3)]


def _tolerance(dtype, want):
    if dtype == torch.float32:
        return 1e-5
    return 2.0 ** -6 * float(np.abs(want).max())


def _tile_rows(dtype, n):
    """The tiles the kernels take at N: bf16 64 rows, f32 64 and 32."""
    return (ROWS, ROWS // 2) if dtype == torch.float32 and n <= 32 \
        else (ROWS,)


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
# G, N, heads: P = 64 // N from 64 (N = 1) to 1; G not a multiple of P
# where P > 1; Pallas at the N its gate takes, the XLA reference at others
PALLAS_CASES = [(5, 16, 4), (3, 32, 2), (2, 48, 3), (3, 64, 1)]
REFERENCE_CASES = [(67, 1, 1), (5, 4, 2), (5, 25, 2), (3, 33, 4)]


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n,heads", PALLAS_CASES + REFERENCE_CASES)
def test_short_training_kernel_matches_jax(g, n, heads, name, dtype,
                                           jdtype):
    """The packed-tile blocking at each tile the kernels take against the
    Pallas kernel (interpret mode) where its gate admits N, else the XLA
    composition."""
    c = 32 * heads
    q, k, v = _arrays(g, n, c, dtype, seed=100 * n + heads)
    jq, jk, jv = (jnp.asarray(t, jdtype) for t in (q, k, v))
    if (g, n, heads) in PALLAS_CASES:
        want = jax_fused(jq, jk, jv, heads, interpret=True)
    else:
        want = area_attention_fused_reference(jq, jk, jv, heads)
    want = np.asarray(want.astype(jnp.float32))
    for rows in _tile_rows(dtype, n):
        got = short_band_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                   heads, dtype, rows=rows)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tolerance(dtype, want),
                                   err_msg=f"rows {rows}")


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n", [(7, 16), (2, 64), (9, 25)])
def test_short_single_head_matches_jax(g, n, name, dtype, jdtype):
    """One head of 32 (`area_attention`, the same kernel at heads = 1)
    against the Pallas `area_attention` in interpret mode at N = 16 and 64
    and `area_attention_reference` at 25, and the port's entry point on the
    CPU (the plain version)."""
    q, k, v = _arrays(g, n, 32, dtype, seed=7 * n + g)
    jq, jk, jv = (jnp.asarray(t, jdtype) for t in (q, k, v))
    want = (jax_single(jq, jk, jv, interpret=True) if n % 16 == 0
            else area_attention_reference(jq, jk, jv))
    want = np.asarray(want.astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    got = short_band_attention(tq, tk, tv, 1, dtype)
    tol = _tolerance(dtype, want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    plain = area_attention(tq.to(dtype), tk.to(dtype), tv.to(dtype))
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
def test_short_training_kernel_at_a_padded_head(name, dtype, jdtype):
    """Two heads of 48 channels at N = 16, padded to 64 by `pad_heads` and
    run with the true scale, cut back: against the Pallas kernel at 48, and
    against the port's entry point on the CPU."""
    g, n, heads, hd = 5, 16, 2, 48
    q, k, v = _arrays(g, n, heads * hd, dtype, seed=48)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    padded = (pad_heads(t, heads, 64) for t in (tq, tk, tv))
    got = cut_heads(short_band_attention(*padded, heads, dtype,
                                         scale=hd ** -0.5), heads, hd)
    want = np.asarray(jax_fused(*(jnp.asarray(t, jdtype) for t in (q, k, v)),
                                heads, interpret=True).astype(jnp.float32))
    tol = _tolerance(dtype, want)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    plain = area_attention_fused(tq.to(dtype), tk.to(dtype), tv.to(dtype),
                                 heads)
    np.testing.assert_allclose(plain.float().numpy(), got.float().numpy(),
                               rtol=0, atol=tol)


SHORT_BANDS = sorted({(n, c) for *_, n, c, _ in SWEEP if n <= ROWS})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_every_short_training_band_takes_the_short_path(dtype):
    """Every kernel C band of 64 tokens or fewer of yolov12 n-x (160^2 to
    256^2, both layers) at batch 1, 8, 16 and 128, at heads of 32 and 64:
    the short path, one device kernel a call, its tile rows (bf16 64; f32
    64, or 32 at N <= 32), shared memory within a block; one token more
    streams."""
    assert {n for n, _ in SHORT_BANDS} == {25, 36, 49, 64}
    assert {c for _, c in SHORT_BANDS} == {64, 128, 256, 384}
    for (n, c), batch, hd, area in itertools.product(
            SHORT_BANDS, (1, 8, 16, 128), (32, 64), (1, 4)):
        g = area * batch
        plan = attention_plan(g, n, c, dtype, False, hd)
        assert (plan.path, plan.launches) == ("short", 1), (n, c, g)
        assert plan.rows in _tile_rows(dtype, n), (n, c, g)
        assert plan.smem == short_smem_bytes(c, dtype, hd, plan.rows, False)
        assert plan.smem <= SMEM_LIMIT
    assert attention_plan(8, 65, 64, dtype, False).path == "streamed"


def test_the_short_training_constants_are_the_kernels():
    """Kernel C's shared memory is the q, k and v tiles (and in f32 the
    probabilities) and one barrier, whatever C, as band_attention_short.cu's
    `short_smem` has it; the C entry takes what `build.bind` gives it: four
    pointers (q, k, v, o), G, N, C, heads, dtype, rows, the scale, the
    stream."""
    for rows, hd, c in itertools.product((64, 32), (32, 64), (64, 384)):
        assert short_smem_bytes(c, torch.bfloat16, hd, rows, False) == (
            1024 + 2 * 3 * rows * hd + 8)
        assert short_smem_bytes(c, torch.float32, hd, rows, False) == (
            1024 + 4 * (3 * rows * hd + rows * attn._LDP) + 8)
    text = (Path(attn.__file__).parent.parent / "csrc"
            / "band_attention_short.cu").read_text()
    assert "const int bars = project ? short_stages(C) : 1;" in text
    assert "const size_t lead = project ? bars * stage : head;" in text
    args = re.search(r'extern "C" int yolou_band_attention_short\((.*?)\)',
                     text, re.S)[1].split(",")
    kinds = ["p" if "*" in a else "f" if "float" in a else "i" for a in args]
    assert kinds == ["p"] * 4 + ["i"] * 6 + ["f", "p"]
    assert ('"yolou_band_attention_short": [vp] * 4 + [ci] * 6 + [cf, vp]'
            in Path(build.__file__).read_text())


def test_the_cpu_training_entry_point_is_the_plain_version():
    """On the CPU the entry point runs the plain version at a short band,
    which agrees with the packed blocking, and counts no launch."""
    g, n, heads, c = 5, 25, 2, 64
    tq, tk, tv = (torch.from_numpy(t) for t in _arrays(g, n, c,
                                                         torch.float32, 3))
    before = dict(area_attention_fused.path_launches)
    o = area_attention_fused(tq, tk, tv, heads)
    want = short_band_attention(tq, tk, tv, heads, torch.float32)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert area_attention_fused.path_launches == before
