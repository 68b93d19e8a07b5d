"""PyTorch port: kernel A at any width C and any head width up to 64.

The JAX gate (`pallas_band_eligible`) asks only N % 16 == 0 and C % heads
== 0. Kernel A's q-projecting streamed kernels keep the head's (C, hd) q
weight columns, and in bf16 the CTA's (rows, C) x tile, in shared memory,
so past a width they would not fit a block: bf16 from 928 channels at
heads of 32 and 512 at heads of 64, f32 from 1344 and 640. There kernel A
takes its wide form (`attention.wide_plan`): the projection launch writes
q, k and v (the GEMM rings over C), and kernel C's streamed attention reads
them. What the CPU can check:

  * the plans: every C up to 8192 at heads of 32 and 64, both types,
    kernels A and C, short and long bands, fits a block; the wide form
    exactly where the q-projecting kernel would not fit; every band of
    yolov12 n-x at 160^2-1280^2 keeps its plan;
  * the plans' bytes against the CUDA source's formulas and constants, and
    the wide entry's binding against its C signature;
  * f32 parity against the JAX package at (1, 400, 928) in 29 heads of 32
    and (1, 400, 512) in 8 heads of 64: the port's kernel A on the CPU (its
    plain version) and an emulation of the wide route (the q | k | v GEMM,
    then kernel C's streamed blocking at the wide plan's query rows and key
    tiles) against the Pallas kernel in interpret mode, within 1e-5.
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import area_attention_qkv_fused as jax_qkv
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels import build
from yolou_tpu_torch.kernels.attention import (_SMEM_LIMIT, AttentionPlan,
                                               area_attention_qkv_fused,
                                               attention_plan,
                                               kv_projection_smem,
                                               stream_rows,
                                               stream_smem_bytes, wide_plan)

from .test_torch_port_long_bands import SWEEP
from .torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(attn.__file__).parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
# the first width the q-projecting streamed kernel does not fit, by type and
# head width (at the bands below)
FIRST_WIDE = {(BF16, 32): 928, (BF16, 64): 512, (F32, 32): 1344,
              (F32, 64): 640}
BANDS = [(1, 100), (8, 400), (4, 400), (8, 1600), (32, 1936), (4, 65),
         (32, 25), (512, 25)]


@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
def test_every_width_has_a_launchable_plan(dtype, hd):
    """C = hd ... 8192 in steps of a head, kernels A and C, bands of 25 to
    1936 tokens: shared memory within a block; bands of 64 tokens or fewer
    the short path; longer ones kernel C's streamed path, and kernel A's
    wherever its q-projecting kernel fits, else its wide form (two device
    kernels, kernel C's query rows); f32 at 1344 / 640 channels and up and
    bf16 at 928 / 512 and up the wide form at every band of 400 tokens or
    more (f32 CTAs of fewer rows fit wider C at short grids)."""
    for c, (g, n) in itertools.product(range(hd, 8193, hd), BANDS):
        for projection in (True, False):
            plan = attention_plan(g, n, c, dtype, projection, hd)
            where = (g, n, c, hd, dtype, projection)
            assert plan.smem <= _SMEM_LIMIT == 232_448, where
            assert g <= 65535 and -(-n // plan.rows) <= 65535
            if n <= 64:
                assert plan.path == "short", where
                continue
            rows = stream_rows(g, n, c, dtype, projection, hd)
            fits = stream_smem_bytes(c, dtype, projection, rows,
                                     hd) <= _SMEM_LIMIT
            want = "wide" if projection and not fits else "streamed"
            assert plan.path == want, where
            assert plan.streamed and plan.launches == (2 if projection
                                                       else 1)
            if want == "wide":
                assert plan == wide_plan(g, n, c, dtype, hd)
                assert plan.rows == stream_rows(g, n, c, dtype, False, hd)
            if c >= FIRST_WIDE[(dtype, hd)] and projection and n >= 400:
                assert plan.path == "wide", where
    below = FIRST_WIDE[(dtype, hd)] - hd        # the widest that fits
    assert attention_plan(8, 400, below, dtype, True, hd).path == "streamed"


@pytest.mark.parametrize("projection", [True, False], ids=["A", "C"])
def test_the_sweep_keeps_its_plans(projection):
    """Every band of yolov12 n-x at 160^2-1280^2 (C up to 384), batch 1 and
    8, both types: the plan the port gave before the wide form (the short
    path at 64 tokens or fewer, else the streamed path at `stream_rows`'
    query rows with `stream_smem_bytes`' shared memory), path, rows and
    bytes, and never the wide form."""
    for (scale, imgsz, layer, n, c, heads), batch, dtype in itertools.product(
            SWEEP, (1, 8), (F32, BF16)):
        g = batch * (4 if layer == 6 and n * 4 == (imgsz // 16) ** 2 else 1)
        plan = attention_plan(g, n, c, dtype, projection)
        if n <= 64:
            assert plan.path == "short"
            continue
        rows = stream_rows(g, n, c, dtype, projection)
        assert plan == AttentionPlan(
            "streamed", stream_smem_bytes(c, dtype, projection, rows),
            2 if projection else 1, rows), (scale, imgsz, layer, g, dtype)


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def test_the_wide_plans_bytes_are_the_kernels():
    """The wide form's shared memory is the larger of its launches': the
    projection (bf16 `kv_projection_bf16_smem`, f32 `kv_projection_f32_smem`
    over gemm_f32.cuh's ring at tiles of KV_TM tokens, neither reading C
    past the bf16 ring's 4 stages) and kernel C's streamed attention
    (`stream_wgmma_smem` / `stream_f32_smem` without the projection); the
    constants are the CUDA source's, the formulas its text."""
    text = (CSRC / "band_attention.cu").read_text()
    gemm = (CSRC / "gemm_f32.cuh").read_text()
    tm, ks = _constant(text, "KV_TM"), _constant(gemm, "KS_F32")
    stages, threads = (_constant(gemm, "GEMM_STAGES"),
                       _constant(gemm, "GEMM_THREADS"))
    np_ = 4 * threads // (tm // 4)                  # GemmTile<TM>::NP
    assert attn._KV_F32_SMEM == (1024 + 4 * stages * (tm * ks + ks * np_)
                                 + 8 * 2 * stages) == 66624
    assert ("return 1024 + sizeof(float) * (size_t)GemmTile<KV_TM>::GEMM +\n"
            "         8 * 2 * GEMM_STAGES;") in text
    for c, hd in itertools.product((928, 2048, 8192), (32, 64)):
        for g, n in ((4, 400), (8, 1600)):
            for dtype in (F32, BF16):
                rows = stream_rows(g, n, c, dtype, False, hd)
                proj = (kv_projection_smem(c) if dtype == BF16
                        else attn._KV_F32_SMEM)
                assert wide_plan(g, n, c, dtype, hd).smem == max(
                    stream_smem_bytes(c, dtype, False, rows, hd), proj)
    # bf16: 4 stages of a 64 x 64 x slab and a 64 x 64 weight box, the
    # staged 64 x 72 tile, 4 barriers
    assert kv_projection_smem(8192) == (1024 + 2 * (4 * 64 * 128 + 64 * 72)
                                        + 32)
    # the projection kernels' wide form (`Q`) writes q too: 3C columns
    # from w's first, where the k / v form writes 2C from column C
    assert text.count("const int cols = Q ? 3 * C : 2 * C;") == 2
    assert "(cols + 64 * NB - 1) / (64 * NB)" in text
    assert "(cols + L::NP - 1) / L::NP" in text
    assert text.count("const int first = Q ? 0 : C") == 2


def test_the_wide_entry_is_bound_as_declared():
    """`yolou_band_attention_qkv_wide`: x, w, b, o, v, k, q, then G, N, C,
    heads, dtype, rows, scale, stream, as `build.bind` declares them."""
    text = (CSRC / "band_attention.cu").read_text()
    args = re.search(r'extern "C" int yolou_band_attention_qkv_wide\((.*?)\)',
                     text, re.S)[1]
    kinds = ["p" if "*" in a else "f" if "float" in a else "i"
             for a in args.split(",")]
    assert kinds == ["p"] * 7 + ["i"] * 6 + ["f", "p"]
    assert ('"yolou_band_attention_qkv_wide": [vp] * 7 + [ci] * 6 + [cf, vp]'
            in Path(build.__file__).read_text())


def wide_route(x, w, b, heads, rows, keys):
    """The wide form's arithmetic on (G, N, C) f32: q | k | v = x . w + b in
    f32 (the projection launch), then kernel C's streamed blocking: query
    blocks of `rows`, the online softmax in steps of `keys` in log2 units
    against a maximum kept in raw units, the division after p.v."""
    g, n, c = x.shape
    hd = c // heads
    qkv = torch.matmul(x, w) + b
    sl2 = torch.tensor(hd ** -0.5 * 1.4426950408889634, dtype=torch.float32)

    def split(t):
        return t.reshape(g, n, heads, hd).transpose(1, 2)

    qh, kh, vh = (split(t) for t in qkv.split(c, -1))
    out = torch.empty_like(qh)
    for r0 in range(0, n, rows):
        qt = qh[:, :, r0:r0 + rows]
        m = torch.full(qt.shape[:-1] + (1,), -torch.inf)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qt)
        for k0 in range(0, n, keys):
            s = qt @ kh[:, :, k0:k0 + keys].transpose(-1, -2)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp2(s * sl2 - m_new * sl2)
            rescale = torch.exp2((m - m_new) * sl2)
            l = l * rescale + p.sum(-1, keepdim=True)
            acc = acc * rescale + p @ vh[:, :, k0:k0 + keys]
            m = m_new
        out[:, :, r0:r0 + rows] = acc / l
    return out.transpose(1, 2).reshape(g, n, c), qkv[..., 2 * c:]


@pytest.mark.parametrize("c,heads", [(928, 29), (512, 8)],
                         ids=["c928-h29", "c512-h8x64"])
def test_wide_widths_match_jax(c, heads):
    """f32 at (1, 400, C): the port's kernel A on the CPU and the wide
    route's emulation at the wide plan's rows and keys against the Pallas
    kernel in interpret mode, o and v within 1e-5."""
    rng = np.random.default_rng(c)
    x = rng.normal(size=(1, 400, c)).astype(np.float32)
    w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c)).astype(np.float32)
    b = rng.normal(0, 0.1, (3 * c,)).astype(np.float32)
    o_jax, v_jax = (np.asarray(t) for t in jax_qkv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)[None], heads,
        interpret=True))
    tx, tw, tb = (torch.from_numpy(t) for t in (x, w, b))
    o, v = area_attention_qkv_fused(tx, tw, tb, heads)
    plan = wide_plan(1, 400, c, F32, c // heads)
    o_wide, v_wide = wide_route(tx, tw, tb, heads, plan.rows,
                                attn._STREAM_KEYS[F32])
    for got, want in ((o, o_jax), (v, v_jax), (o_wide, o_jax),
                      (v_wide, v_jax)):
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert np.abs(o_jax).max() > 0.05
