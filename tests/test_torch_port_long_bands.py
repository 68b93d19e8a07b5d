"""PyTorch port: kernels A and C at every band length the JAX package takes.

The JAX gate (`pallas_band_eligible`) asks only N % 16 == 0 and C % heads
== 0, so a served or trained model gives the kernels bands of up to 1600
tokens (1280^2) and more. `kernels/attention.py::attention_plan` sends
every band of 64 tokens or fewer to the short path and every longer one to
the streamed path, which passes keys and values through shared memory in
tiles, in both kernels and both types. What the CPU can check:

  * the plan: every band of yolov12 n-x at 160^2-1280^2 (steps of 32,
    layers 6 and 8, batch 1 and 8, both types, kernels A and C) gets a
    launchable plan (shared memory within a block's 232,448 bytes);
    yolov12n's bands take the short path at 160^2 and the streamed one at
    640^2;
  * the streamed path's launches: every band of the sweep takes a valid
    number of query rows a CTA (f32 64, 32 or 16; bf16 128 or 64), a grid
    within the card's limits and shared memory within a block, and the
    port's constants are the CUDA source's;
  * the arithmetic at long bands: `test_torch_port_attention_tiling.py`'s
    emulation of the streamed blocking (R-row query blocks, the ring's key
    tiles, exp2 with the folded scale) at N = 1024, 1600 and 1936, at the
    query rows the plan gives one band and eight, against the Pallas
    kernels in interpret mode (f32 within 1e-5, bf16 within 2^-6 of the
    output's largest magnitude, as that file states).
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import area_attention_fused as jax_fused
from yolou_tpu.ops.pallas_attn import area_attention_qkv_fused as jax_qkv
from yolou_tpu.ops.pallas_attn import pallas_band_eligible
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels.attention import (_STREAM_KEYS, attention_plan,
                                               short_smem_bytes,
                                               stream_smem_bytes,
                                               streamed_plan)
from yolou_tpu_torch.models.specs import (YOLOV12_SCALES, scale_channels,
                                          scale_depth)

from .test_torch_port_attention_tiling import (HD, STREAM_KEYS, _arrays,
                                               _tolerance, streamed_attention)
from .torch_threads import one_torch_thread  # noqa: F401

SMEM_LIMIT = 232_448          # a block's shared memory on an H100, bytes


def yolov12_bands(scale: str, imgsz: int):
    """(layer, N, C, heads) of the attention bands of yolov12's layers 6
    (area 4) and 8 (area 1) at `imgsz`, as the AAttn modules cut them."""
    _, width, max_ch = YOLOV12_SCALES[scale]
    out = []
    for layer, c2, stride, area in ((6, 512, 16, 4), (8, 1024, 32, 1)):
        c = scale_channels(c2, width, max_ch) // 2        # AAttn's dim, c_
        tokens = (imgsz // stride) ** 2
        n = tokens // area if tokens % area == 0 else tokens
        out.append((layer, n, c, max(1, c // 32)))
    return out


SWEEP = [(scale, imgsz, *band)
         for scale, imgsz in itertools.product(YOLOV12_SCALES,
                                               range(160, 1281, 32))
         for band in yolov12_bands(scale, imgsz)]


def test_the_sweep_covers_the_long_band_shapes():
    assert len(SWEEP) == 5 * 36 * 2
    assert ("s", 640, 8, 400, 256, 8) in SWEEP
    assert ("x", 640, 8, 400, 384, 12) in SWEEP
    assert ("n", 1280, 6, 1600, 64, 2) in SWEEP
    assert ("n", 1280, 8, 1600, 128, 4) in SWEEP
    assert scale_depth(4, YOLOV12_SCALES["l"][0]) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("projection", [True, False], ids=["A", "C"])
def test_every_band_of_the_sweep_has_a_launchable_plan(projection, dtype):
    """Kernel A (`projection`) and kernel C, batch 1 and 8: shared memory
    within a block for every band the JAX gate admits (and the others of
    the sweep); the bands of 64 tokens or fewer the short path, the others
    the streamed path, in both types."""
    admitted = 0
    for scale, imgsz, layer, n, c, heads in SWEEP:
        for batch in (1, 8):
            g = batch * (4 if layer == 6 and n * 4 == (imgsz // 16) ** 2
                         else 1)
            plan = attention_plan(g, n, c, dtype, projection)
            where = (scale, imgsz, layer, g, n, c, dtype, projection)
            assert plan.smem <= SMEM_LIMIT, where
            short = n <= 64
            assert plan.path == ("short" if short else "streamed"), where
            assert plan.launches == (2 if plan.streamed and projection
                                     else 1)
            if plan.streamed:
                assert plan.rows in ((128, 64) if dtype == torch.bfloat16
                                     else (64, 32, 16)), where
                assert plan.smem == stream_smem_bytes(c, dtype, projection,
                                                      plan.rows)
                assert g <= 65535 and -(-n // plan.rows) <= 65535, where
            else:
                assert n <= plan.rows in (64, 32), where
                assert plan.smem == short_smem_bytes(c, dtype, 32, plan.rows,
                                                     projection)
        admitted += pallas_band_eligible(n, c, heads)
    assert admitted == 90


def _source_constant(name: str) -> int:
    text = (Path(attn.__file__).parent.parent / "csrc"
            / "band_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_streamed_constants_are_the_kernels():
    """`stream_smem_bytes` and `stream_rows` mirror band_attention.cu: its
    key tiles, ring stages, warpgroup rows and f32 probability stride; the
    shared memory formula at both types, both kernels and every row count,
    and the rows `attention_plan` gives by the grid."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert _STREAM_KEYS == {f32: _source_constant("KB_F32"),
                            bf16: _source_constant("KB_MMA")}
    assert attn._STREAM_STAGES == {f32: _source_constant("STAGES_F32"),
                                   bf16: _source_constant("STAGES_MMA")}
    assert attn._WG_ROWS == _source_constant("WG_ROWS")
    assert STREAM_KEYS == _STREAM_KEYS      # the emulation's softmax steps
    assert attn._LDP == _source_constant("LDP")
    for rows, c in itertools.product((64, 32, 16), (64, 384)):
        # 1024 slack, 2 x 2 tiles, q and P, kernel A's q weights, barriers
        assert stream_smem_bytes(c, f32, False, rows) == (
            1024 + 4 * (2 * 2 * 64 * 32 + rows * (32 + 76)) + 8 * 5)
        assert stream_smem_bytes(c, f32, True, rows) == (
            1024 + 4 * (2 * 2 * 64 * 32 + rows * (32 + 76) + 32 * c) + 8 * 5)
    for rows, c in itertools.product((128, 64), (64, 384)):
        assert stream_smem_bytes(c, bf16, False, rows) == (
            1024 + 2 * (2 * 3 * 128 * 32 + rows * 32) + 8 * 7)
        assert stream_smem_bytes(c, bf16, True, rows) == (
            1024 + 2 * (2 * 3 * 128 * 32 + rows * 32 + 32 * c + rows * c)
            + 8 * 7)
    # f32: kernel C 32 rows where that grid covers half of the 132 SMs,
    # else 16; kernel A 64 at 256 channels and up where 64-row CTAs are 8
    # deep on each SM
    assert attention_plan(32, 1024, 64, f32, False).rows == 32
    assert attention_plan(8, 400, 128, f32).rows == 32
    assert streamed_plan(4, 25, 64, f32).rows == 16   # kernel A forced
    assert streamed_plan(4, 25, 64, f32, False).rows == 16  # C forced
    assert attention_plan(32, 400, 256, f32).rows == 64
    assert attention_plan(32, 400, 256, f32, False).rows == 32
    # bf16: two consumer warpgroups in kernel A at 384 channels, or where
    # 128-row CTAs are 16 deep on each SM; one otherwise and up to 64 tokens
    assert attention_plan(32, 1936, 64, bf16, False).rows == 64
    assert attention_plan(32, 1600, 384, bf16).rows == 128
    assert attention_plan(32, 1600, 384, bf16, False).rows == 128
    assert attention_plan(8, 400, 384, bf16, False).rows == 64
    assert streamed_plan(512, 25, 64, bf16).rows == 64
    assert streamed_plan(512, 25, 384, bf16).rows == 64

@pytest.mark.parametrize("projection", [True, False], ids=["A", "C"])
def test_the_resident_path_keeps_the_bands_it_took(projection):
    """yolov12n's bands at 160^2 (25 tokens: serving and training at batch
    8, evaluation and the fine-tune at 16, objectmaps at 128), which the
    resident kernels took in bf16 before the short path, take the short
    path in both kernels and both types (one launch); its 640^2 bands (400
    tokens) take the streamed path in both kernels, as measured on an H100
    (`tools/attention_routes.py`); so does every band past 64 tokens,
    however little its work."""
    f32, bf16 = torch.float32, torch.bfloat16
    for imgsz, batches in ((160, (8, 16, 128)), (640, (8,))):
        for batch, (layer, n, c, _) in itertools.product(
                batches, yolov12_bands("n", imgsz)):
            g = batch * (4 if layer == 6 else 1)
            for dtype in (f32, bf16):
                plan = attention_plan(g, n, c, dtype, projection)
                assert plan.path == ("streamed" if imgsz == 640
                                     else "short")
    assert attention_plan(8, 400, 256, bf16, projection).streamed  # s-l L8
    assert attention_plan(1, 400, 256, bf16, projection).streamed
    assert attention_plan(1, 100, 128, bf16, projection).streamed
    assert attention_plan(1, 65, 128, f32, projection).streamed
    assert attention_plan(32, 1600, 64, bf16, projection).streamed  # @1280
    assert attention_plan(32, 1936, 64, bf16, projection).streamed  # @1408
    assert attention_plan(512, 25, 64, bf16, projection).path == "short"
    assert attention_plan(1, 64, 384, f32, projection).path == "short"


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
LONG = [(1, 1024, 2), (1, 1600, 1), (1, 1936, 1)]      # G, N, heads


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n,heads", LONG)
def test_training_kernel_at_long_bands_matches_jax(g, n, heads, name, dtype,
                                                   jdtype):
    """Kernel C's order at N = 1024-1936 against the Pallas
    `area_attention_fused`: the streamed blocking at the rows
    `attention_plan` gives one such band and eight."""
    c = HD * heads
    q, k, v = _arrays([((g, n, c), 1.0)] * 3, seed=n + heads, dtype=dtype)
    want = np.asarray(jax_fused(*(jnp.asarray(t, jdtype) for t in (q, k, v)),
                                heads).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    for batch in (1, 8):
        plan = attention_plan(batch * g, n, c, dtype, False)
        assert plan.streamed
        got = streamed_attention(tq, tk, tv, heads, dtype, plan.rows)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                                   atol=_tolerance(dtype, want),
                                   err_msg=f"{plan.rows} rows")


@pytest.mark.parametrize("name,dtype,jdtype", DTYPES,
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("g,n,heads", LONG)
def test_eval_kernel_at_long_bands_matches_jax(g, n, heads, name, dtype,
                                               jdtype):
    """Kernel A at N = 1024-1936: the projection (f32 accumulation, f32
    bias, rounded to the I/O type) then the streamed blocking, against the
    Pallas `area_attention_qkv_fused`."""
    c = HD * heads
    x, w, b = _arrays([((g, n, c), 1.0), ((c, 3 * c), 0.5 / np.sqrt(c)),
                       ((3 * c,), 0.1)], seed=n + 7 * heads, dtype=dtype)
    b = b.astype(np.float32)
    want_o, want_v = (np.asarray(t.astype(jnp.float32)) for t in jax_qkv(
        jnp.asarray(x, jdtype), jnp.asarray(w, jdtype), jnp.asarray(b)[None],
        heads))
    qkv = (torch.from_numpy(x) @ torch.from_numpy(w)
           + torch.from_numpy(b)).to(dtype).float()
    q, k, v = qkv.split(c, -1)
    got = streamed_attention(q, k, v, heads, dtype,
                             attention_plan(8 * g, n, c, dtype).rows)
    np.testing.assert_allclose(got.float().numpy(), want_o, rtol=0,
                               atol=_tolerance(dtype, want_o))
    v_tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * np.abs(want_v).max()
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=v_tol)
