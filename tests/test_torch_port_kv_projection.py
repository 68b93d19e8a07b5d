"""PyTorch port: kernel A's bf16 k/v projection on the streamed path
(`kv_projection_wgmma_kernel` in `csrc/band_attention.cu`), emulated on the
CPU, against the JAX package.

The CUDA kernel runs only on the card; what the CPU can check is its
blocking and rounding. `wgmma_projection` repeats it: the (G N) tokens
flattened across bands and cut into tiles of 64 (a tile crosses band
boundaries; the last is cut at G N), the 2C k | v columns into panels of
64 (columns past 2C read zero weights and are not stored), the channels
into ring stages of 64 (channels past C read zero), each stage's four
16-channel products (exact bf16 products, summed at least in f32: here in
float64, rounded to f32) added to an f32 accumulator in order, then the f32
bias and one rounding to bf16; k and v land where the tile's tokens and the
panel's columns say.

Held against the Pallas `area_attention_qkv_fused` in interpret mode (its
`v` output is the projection's value half) and against
`_qkv_attn_reference` (the XLA composition), at N = 25, 100 and 400, G not
a multiple of the tile (G N not a multiple of 64), C = 64, 128 and 256,
heads of 32 and 64 and two heads of 48 padded to 64 (`pad_qkv_projection`):
within one bf16 step at the output's largest magnitude (2**-7 max|v|: both
sides round one f32 sum, which differ only in their order, to bf16). k is
held against the float64 product within the same step. The constants are
the CUDA source's, and the streamed plan's shared memory is the launch's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import _qkv_attn_reference
from yolou_tpu.ops.pallas_attn import area_attention_qkv_fused as jax_qkv
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels.attention import (area_attention_qkv_fused,
                                               attention_plan,
                                               kv_projection_smem,
                                               pad_qkv_projection)

from .torch_threads import one_torch_thread  # noqa: F401

TM = 64            # tokens a CTA
KS = 64            # channels a ring stage
COLS = 64          # columns a panel
STAGES = 4         # the ring's stages at most


def wgmma_projection(x: np.ndarray, w: np.ndarray, b: np.ndarray):
    """The kernel's blocking on f32 arrays holding bf16 values: x (G, N, C),
    w (C, 3C), b (3C,) f32; returns (k, v, written), k and v (G, N, C) as
    bf16 values in f32, `written` how often each output was stored."""
    g, n, c = x.shape
    tokens = g * n
    xs = x.reshape(tokens, c)
    out = np.zeros((tokens, 2 * c), np.float32)
    written = np.zeros((tokens, 2 * c), int)
    for tok0 in range(0, tokens, TM):
        xt = np.zeros((TM, -(-c // KS) * KS), np.float64)
        rows = min(TM, tokens - tok0)
        xt[:rows, :c] = xs[tok0:tok0 + rows]
        for col0 in range(0, 2 * c, COLS):
            wt = np.zeros((xt.shape[1], COLS), np.float64)
            cols = min(COLS, 2 * c - col0)
            wt[:c, :cols] = w[:, c + col0:c + col0 + cols]
            acc = np.zeros((TM, COLS), np.float32)
            for k0 in range(0, xt.shape[1], 16):   # 4 steps a stage, in order
                acc = acc + (xt[:, k0:k0 + 16] @ wt[k0:k0 + 16]
                             ).astype(np.float32)
            bias = np.zeros(COLS, np.float32)
            bias[:cols] = b[c + col0:c + col0 + cols]
            tile = torch.from_numpy(acc + bias).to(torch.bfloat16).float()
            out[tok0:tok0 + rows, col0:col0 + cols] = \
                tile[:rows, :cols].numpy()
            written[tok0:tok0 + rows, col0:col0 + cols] += 1
    k, v = out[:, :c].reshape(g, n, c), out[:, c:].reshape(g, n, c)
    return k, v, written


def _arrays(g, n, c, seed):
    """Seeded x, w rounded to bf16 and b (f32), as numpy f32."""
    rng = np.random.default_rng(seed)

    def mk(shape, std):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(torch.bfloat16).float().numpy()

    x, w = mk((g, n, c), 1.0), mk((c, 3 * c), 0.5 / np.sqrt(c))
    return x, w, rng.normal(0, 0.1, (3 * c,)).astype(np.float32)


# G, N, C, heads (head width C / heads): G N never a multiple of 64
CASES = [(5, 25, 64, 2), (3, 100, 128, 4), (3, 400, 256, 8),
         (3, 100, 128, 2), (1, 25, 256, 4), (3, 100, 96, 2)]


@pytest.mark.parametrize("g,n,c,heads", CASES)
def test_wgmma_projection_matches_jax(g, n, c, heads):
    """The tiles-across-bands blocking against the Pallas kernel's v
    (interpret mode) and the XLA composition's, and k against the float64
    product; heads of 48 padded to 64 as the wrapper pads them."""
    assert (g * n) % TM
    x, w, b = _arrays(g, n, c, seed=g * n + c)
    hd = c // heads
    if hd not in (32, 64):           # the wrapper's zero channels
        xp, wp, bp = (t.numpy() for t in pad_qkv_projection(
            *(torch.from_numpy(t) for t in (x, w, b)), heads, 64))
    else:
        xp, wp, bp = x, w, b
    k, v, written = wgmma_projection(xp, wp, bp)
    assert (written == 1).all()      # every output stored once
    cp = xp.shape[-1]
    want_k = (xp.reshape(-1, cp).astype(np.float64)
              @ wp[:, cp:2 * cp].astype(np.float64) + bp[cp:2 * cp])
    tol_k = 2.0 ** -7 * np.abs(want_k).max()
    np.testing.assert_allclose(k.reshape(-1, cp), want_k, rtol=0, atol=tol_k)
    if hd not in (32, 64):           # back to the true heads' channels
        v = v.reshape(g, n, heads, 64)[..., :hd].reshape(g, n, c)
    jx, jw, jb = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                  jnp.asarray(b)[None])
    for _, want_v in (jax_qkv(jx, jw, jb, heads, interpret=True),
                      _qkv_attn_reference(jx, jw, jb, heads)):
        want_v = np.asarray(want_v.astype(jnp.float32))
        np.testing.assert_allclose(v, want_v, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want_v).max())


def test_the_wrapper_gives_the_plain_projection_on_the_cpu():
    """On a CPU tensor the wrapper runs the plain version, whose v is the
    emulation's within the same step."""
    g, n, c, heads = 3, 100, 128, 4
    x, w, b = _arrays(g, n, c, seed=7)
    _, v = area_attention_qkv_fused(
        *(torch.from_numpy(t).to(torch.bfloat16) for t in (x, w)),
        torch.from_numpy(b), heads)
    _, want, _ = wgmma_projection(x, w, b)
    np.testing.assert_allclose(v.float().numpy(), want, rtol=0,
                               atol=2.0 ** -7 * np.abs(want).max())


def _source_constant(name: str) -> int:
    text = (Path(attn.__file__).parent.parent / "csrc"
            / "band_attention.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_projection_constants_are_the_kernels():
    """Tile, stage and ring constants are band_attention.cu's, the panel
    is the one the launch takes, the shared memory formula is the
    kernel's, and the streamed bf16 plan covers the projection launch."""
    assert TM == attn._KVB_TM == _source_constant("KVB_TM")
    assert KS == attn._KVB_KS == _source_constant("KVB_KS")
    assert STAGES == attn._KVB_STAGES == _source_constant("KVB_STAGES")
    assert COLS == attn._KVB_COLS == 64 * _source_constant("KVB_NB")
    for c, stages in ((32, 1), (64, 1), (128, 2), (256, 4), (384, 4)):
        # 1024 slack, the ring (x slab + panel), the staged tile, barriers
        assert kv_projection_smem(c) == (
            1024 + 2 * (stages * 64 * (64 + 64) + 64 * 72) + 8 * stages)
    for g, n, c in ((32, 400, 64), (8, 400, 128), (8, 400, 256),
                    (8, 400, 384), (32, 1600, 64)):
        plan = attention_plan(g, n, c, torch.bfloat16)
        assert plan.streamed and plan.launches == 2
        assert plan.smem >= kv_projection_smem(c)


def test_the_route_summary_counts_the_resident_wins():
    """`tools/attention_routes.py::summarize` (the sweep behind
    `attention_plan` and `short_rows`): the plan's cost against the fastest
    path, recorded and with today's plan, and at the bands of 64 tokens or
    fewer the short path's wins against the best streamed row count (the
    path the resident kernels' bands moved to), on two hand-made rows."""
    from yolou_tpu_torch.tools.attention_routes import summarize
    rows = [{"kernel": "C", "dtype": "bfloat16", "g": 16, "n": 25, "c": 128,
             "heads": 4, "short_ms": {"64": [0.002, 0.002]},
             "streamed_ms": {"128": [0.004, 0.004], "64": [0.003, 0.003]},
             "plan": "streamed", "plan_rows": 64},
            {"kernel": "C", "dtype": "bfloat16", "g": 8, "n": 400, "c": 128,
             "heads": 4, "short_ms": None,
             "streamed_ms": {"128": [0.016, 0.016], "64": [0.014, 0.014]},
             "plan": "streamed", "plan_rows": 64}]
    got = summarize(rows)["C bfloat16"]
    assert (got["bands"], got["short_bands"], got["short_wins"]) == (2, 1, 1)
    assert got["short_over_streamed_worst"] == pytest.approx(2 / 3)
    assert got["plan_over_best_worst"] == pytest.approx(1.5)
    # today's plan takes the short path at 25 tokens and streams at 400
    replanned = summarize(rows, replan=True)["C bfloat16"]
    assert replanned["plan_over_best_worst"] == pytest.approx(1.0)
    assert attention_plan(1, 100, 128, torch.bfloat16, False).rows == 64
