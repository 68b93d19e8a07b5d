"""PyTorch port: the CUDA kernels against their plain versions on the card,
at shapes off the serving path (ragged bands, token tiles and candidate
counts, one to many heads, heads of any width (the blocked form past 64),
more tiles than one
co-resident wave, side streams, both paths of the band attention kernels
(short and streamed),
the whole-A2C2f kernel at other MLP widths (h in shared or in global
memory), any stage count and each layout of its f32 kernel; kernel A's
wide form at widths C up to 2048), and the wrappers' refusals.

Marked `cuda`; without a CUDA device each test skips. The file imports
neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

(`--noconftest`: the repository's conftest imports JAX.) chip_smoke.py
checks the same kernels at the serving shapes and drives the serving path.
"""

import numpy as np
import pytest
import torch

from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels import build
from yolou_tpu_torch.kernels.a2c2f import (_launch_a2c2f, a2c2f_fused,
                                           a2c2f_fused_plain)
from yolou_tpu_torch.kernels.attention import (
    _launch_band_attention, _launch_qkv_attention, area_attention,
    area_attention_fused, area_attention_fused_plain, area_attention_plain,
    area_attention_qkv_fused, area_attention_qkv_fused_plain, attention_plan,
    cut_heads, pad_heads, pad_qkv_projection, padded_head_dim)
from yolou_tpu_torch.kernels.nms import suppress_greedy, suppress_greedy_plain
from yolou_tpu_torch.models.specs import YOLOV12_SCALES, scale_channels

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    matmul, cudnn = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False     # exact f32 plain version
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


def _attn_inputs(g, n, c, dtype, device, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, n, c))
    w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c))
    b = rng.normal(0, 0.1, (3 * c,))
    return (torch.tensor(x, dtype=dtype, device=device),
            torch.tensor(w, dtype=dtype, device=device),
            torch.tensor(b, dtype=torch.float32, device=device))


# N around 16-row tiles and the key tiles, the 160^2 and 640^2 band
# lengths, "max", the longest band the short path takes (64 tokens), and
# "over", one token more (the streamed path); one to four heads, up to 64
# bands
TILE_CASES = [(64 if n in (1, 15, 16, 17, 25, 33) else 4 if n in (399, 400)
               else 2, n, heads)
              for n in (1, 15, 16, 17, 25, 33, 399, 400, "max", "over")
              for heads in (1, 2, 4)]


def _band(n, heads, dtype, projection):
    c = 32 * heads
    if n in ("max", "over"):
        return SHORT_MAX + (n == "over"), c
    return n, c


SHORT_MAX = 64     # the longest band of the short path, both kernels


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g,n,heads", [(1, 1, 1), (3, 7, 2), (5, 31, 3),
                                       (2, 33, 4), (7, 100, 2), (2, 257, 1),
                                       (200, 64, 2), (1, 513, 2)]
                         + TILE_CASES)
def test_band_attention_matches_plain(cuda, g, n, heads, dtype, tol):
    """Any N >= 1 (ragged last key tile, one or many CTAs per band), one to
    four heads; f32 within 1e-4, bf16 within 2e-2 (outputs of order 1; its
    probabilities are rounded to bf16 against a running maximum)."""
    n, c = _band(n, heads, dtype, projection=True)
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=g * n + heads)
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention"] == 1
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    assert o.dtype == v.dtype == dtype and o.shape == v.shape == x.shape
    assert bool(torch.isfinite(o).all() and torch.isfinite(v).all())
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (v.float() - v_ref.float()).abs().max().item() <= tol


def test_band_attention_on_a_side_stream(cuda):
    x, w, b = _attn_inputs(8, 400, 128, torch.bfloat16, cuda, seed=1)
    ref = area_attention_qkv_fused_plain(x, w, b, 4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o, v = area_attention_qkv_fused(x, w, b, 4)
    torch.cuda.current_stream().wait_stream(side)
    assert (o.float() - ref[0].float()).abs().max().item() <= 2e-2
    assert (v.float() - ref[1].float()).abs().max().item() <= 2e-2


def test_band_attention_refuses_what_it_cannot_run(cuda):
    """Alignment and device are refused, and a path the kernel has not
    (the resident one is gone), and the short path past 64 tokens; a head of
    48 is not (padded to 64 in the wrapper, the short path at 16 tokens,
    within 1e-4 of the plain version), nor a long band (N = 1025 in bf16,
    1000 in f32): they run the streamed path (two device kernels, one count)
    and agree with the plain version."""
    x, w, b = _attn_inputs(2, 16, 96, torch.float32, cuda, seed=2)
    o, v = area_attention_qkv_fused(x, w, b, 2)       # head_dim 48
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, 2)
    assert (o - o_ref).abs().max().item() <= 1e-4
    assert (v - v_ref).abs().max().item() <= 1e-4
    for dtype, n, tol in ((torch.float32, 1000, 1e-4),
                          (torch.bfloat16, 1025, 2e-2)):
        assert attention_plan(1, n, 128, dtype).streamed
        x, w, b = _attn_inputs(1, n, 128, dtype, cuda, seed=3)
        kernels.reset_launch_counts()
        o, v = area_attention_qkv_fused(x, w, b, 4)
        assert kernels.launch_counts()["band_attention"] == 1
        assert kernels.device_counts()["band_attention"] == 2
        o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, 4)
        assert (o.float() - o_ref.float()).abs().max().item() <= tol
        assert (v.float() - v_ref.float()).abs().max().item() <= tol
    x, w, b = _attn_inputs(1, 17, 64, torch.bfloat16, cuda, seed=3)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        area_attention_qkv_fused(shifted.view(x.shape), w, b, 2)
    x, w, b = _attn_inputs(2, 16, 64, torch.float32, cuda, seed=4)
    with pytest.raises(ValueError, match="one device"):
        area_attention_qkv_fused(x, w.cpu(), b, 2)
    with pytest.raises(ValueError, match="path must be one of"):
        _launch_qkv_attention(x, w, b, 2, "resident")
    x, w, b = _attn_inputs(1, 65, 64, torch.float32, cuda, seed=4)
    with pytest.raises(ValueError, match="64 tokens or fewer"):
        _launch_qkv_attention(x, w, b, 2, "short")
    with pytest.raises(ValueError, match="path must be one of"):
        _launch_qkv_attention(x, w, b, 2, "cluster")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2.0 ** -8)])
@pytest.mark.parametrize("n", [1, 25, 400])
@pytest.mark.parametrize("heads", [2, 4])
def test_band_attention_gradients_match_autograd(cuda, heads, n, dtype, tol):
    """Kernel A is differentiable: (dx, dw, db) for cotangents on both
    outputs (kernel forward, the plain version's VJP as backward) against
    autograd through the plain version. f32 within 1e-4; bf16 within 2^-8
    of the largest gradient (one bf16 step: the same backward code over the
    same saved inputs)."""
    c = 32 * heads
    x, w, b = _attn_inputs(4, n, c, dtype, cuda, seed=n + heads)
    for t in (x, w, b):
        t.requires_grad_()
    rng = np.random.default_rng(n)
    do, dv = (torch.tensor(rng.normal(size=x.shape), dtype=dtype,
                           device=cuda) for _ in range(2))
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, heads)
    got = torch.autograd.grad((o, v), (x, w, b), (do, dv))
    assert kernels.launch_counts()["band_attention"] == 1
    assert kernels.backward_counts()["band_attention"] == 1
    want = torch.autograd.grad(area_attention_qkv_fused_plain(x, w, b, heads),
                               (x, w, b), (do, dv))
    for a, r in zip(got, want):
        assert a.dtype == r.dtype and bool(torch.isfinite(a).all())
        scale = 1.0 if dtype == torch.float32 else r.abs().max().item()
        assert (a.float() - r.float()).abs().max().item() <= tol * scale


def _qkv_inputs(g, n, c, dtype, device, seed, grad=False):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=(g, n, c)), dtype=dtype,
                              device=device, requires_grad=grad)
                 for _ in range(3))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g,n,heads", [(1, 1, 1), (3, 7, 2), (2, 33, 3),
                                       (2, 257, 4), (1, 513, 2),
                                       (40, 100, 2)] + TILE_CASES)
def test_training_attention_matches_plain(cuda, g, n, heads, dtype, tol):
    """Kernel C off the training shapes: any N >= 1, one to four heads; f32
    within 1e-4, bf16 within 2e-2 (outputs of order 1)."""
    n, c = _band(n, heads, dtype, projection=False)
    q, k, v = _qkv_inputs(g, n, c, dtype, cuda, seed=g * n + heads)
    kernels.reset_launch_counts()
    o = area_attention_fused(q, k, v, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention_train"] == 1
    ref = area_attention_fused_plain(q, k, v, heads)
    assert o.dtype == dtype and o.shape == q.shape
    assert bool(torch.isfinite(o).all())
    assert (o.float() - ref.float()).abs().max().item() <= tol


def test_training_attention_on_a_side_stream(cuda):
    q, k, v = _qkv_inputs(32, 400, 64, torch.bfloat16, cuda, seed=8)
    ref = area_attention_fused_plain(q, k, v, 2)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        o = area_attention_fused(q, k, v, 2)
    torch.cuda.current_stream().wait_stream(side)
    assert (o.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_training_attention_gradients_match_autograd(cuda, dtype, tol):
    """dq, dk, dv of the Function (kernel forward, hand-written backward)
    against autograd through the plain version, same cotangent."""
    q, k, v = _qkv_inputs(4, 33, 64, dtype, cuda, seed=5, grad=True)
    do = torch.tensor(np.random.default_rng(6).normal(size=q.shape),
                      dtype=dtype, device=cuda)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(area_attention_fused(q, k, v, 2), (q, k, v), do)
    want = torch.autograd.grad(area_attention_fused_plain(q, k, v, 2),
                               (q, k, v), do)
    assert kernels.backward_counts()["band_attention_train"] == 1
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert (a.float() - b.float()).abs().max().item() <= tol


def test_single_head_attention_matches_plain(cuda):
    q, k, v = _qkv_inputs(9, 50, 32, torch.float32, cuda, seed=7)
    kernels.reset_launch_counts()
    o = area_attention(q, k, v)
    assert kernels.launch_counts()["band_attention_single"] == 1
    assert kernels.launch_counts()["band_attention_train"] == 0
    assert (o - area_attention_plain(q, k, v)).abs().max().item() <= 1e-4


def test_training_attention_refuses_what_it_cannot_run(cuda):
    """Device, contiguity and type are refused, and a path the kernel has
    not (the resident one is gone), and the short path past 64 tokens; a
    head of 48 is not (padded to 64, within 1e-4 of the plain version),
    nor a head of 96 (padded to 128, the blocked path, within 1e-4); a long
    band (N = 1809 in bf16, 1000 in f32) runs the streamed path and agrees
    with the plain version."""
    q, k, v = _qkv_inputs(2, 16, 96, torch.float32, cuda, seed=2)
    o = area_attention_fused(q, k, v, 2)              # head_dim 48
    assert (o - area_attention_fused_plain(q, k, v, 2)).abs().max() <= 1e-4
    kernels.reset_launch_counts()
    o = area_attention(q, k, v)                       # one head of 96
    assert kernels.path_counts("band_attention_single") == {
        "blocked f32 padded": 1}
    assert (o - area_attention_plain(q, k, v)).abs().max() <= 1e-4
    with pytest.raises(ValueError, match="64 tokens or fewer"):
        _launch_band_attention(*_qkv_inputs(2, 65, 128, torch.bfloat16, cuda,
                                            seed=5), 2, "short")
    for dtype, n, tol in ((torch.float32, 1000, 1e-4),
                          (torch.bfloat16, 1809, 2e-2)):
        assert attention_plan(1, n, 32, dtype, projection=False).streamed
        q, k, v = _qkv_inputs(1, n, 32, dtype, cuda, seed=3)
        kernels.reset_launch_counts()
        o = area_attention_fused(q, k, v, 1)
        assert kernels.launch_counts()["band_attention_train"] == 1
        ref = area_attention_fused_plain(q, k, v, 1)
        assert (o.float() - ref.float()).abs().max().item() <= tol
    q, k, v = _qkv_inputs(2, 16, 64, torch.float32, cuda, seed=4)
    with pytest.raises(ValueError, match="one device"):
        area_attention_fused(q, k.cpu(), v, 2)
    with pytest.raises(ValueError, match="contiguous"):
        area_attention_fused(q.transpose(0, 1).contiguous().transpose(0, 1),
                             k, v, 2)
    with pytest.raises(TypeError, match="dtype"):
        area_attention_fused(q.half(), k.half(), v.half(), 2)
    with pytest.raises(ValueError, match="path must be one of"):
        _launch_band_attention(q, k, v, 2, "resident")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g,n,heads", [(3, 1, 1), (2, 15, 2), (2, 33, 4),
                                       (2, 127, 1), (2, 128, 2), (2, 129, 3),
                                       (4, 400, 2), (1, 1025, 4),
                                       (70, 64, 1)])
def test_streamed_path_matches_plain_at_any_band(cuda, g, n, heads, dtype,
                                                 tol):
    """The streamed path of kernels A and C forced at short and long
    bands: around its key tiles (64 keys in f32, 128 in bf16) and query
    blocks (the plan's: 64, 32 or 16 rows in f32, 128 or 64 in bf16), one
    to four heads, many bands; the plain version's tolerances."""
    c = 32 * heads
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=n + heads)
    o, v = _launch_qkv_attention(x, w, b, heads, "streamed")
    torch.cuda.synchronize()
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    assert (o.float() - o_ref.float()).abs().max().item() <= tol
    assert (v.float() - v_ref.float()).abs().max().item() <= tol
    q, k, v = _qkv_inputs(g, n, c, dtype, cuda, seed=n + 2 * heads)
    o = _launch_band_attention(q, k, v, heads, "streamed")
    torch.cuda.synchronize()
    ref = area_attention_fused_plain(q, k, v, heads)
    assert bool(torch.isfinite(o).all())
    assert (o.float() - ref.float()).abs().max().item() <= tol


STREAM_ROWS = [(torch.float32, 1e-4, rows) for rows in (64, 32, 16)] + [
    (torch.bfloat16, 2e-2, rows) for rows in (128, 64)]
RAGGED = (1, 15, 17, 63, 65, 127, 129, 1023, 1937)


@pytest.mark.parametrize("n", RAGGED)
@pytest.mark.parametrize("dtype,tol,rows", STREAM_ROWS,
                         ids=[f"{str(d)[6:]}-{r}" for d, _, r in STREAM_ROWS])
def test_streamed_kernels_at_ragged_bands(cuda, dtype, tol, rows, n):
    """Both redesigned streamed kernels (f32 FMA micro-tiles, bf16 wgmma),
    both forms (kernel A projects q from x, kernel C reads it by TMA), at
    every query-block size, at N around the key tiles (64 / 128) and query
    blocks: the last key tile ragged, the zero rows TMA fills past N masked,
    a CTA's last rows (or a whole consumer warpgroup's) past N; against the
    plain version within its tolerance."""
    g, heads = 3, 2
    c = 32 * heads
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=n + rows)
    o, v = _launch_qkv_attention(x, w, b, heads, "streamed", rows=rows)
    q, k, vv = _qkv_inputs(g, n, c, dtype, cuda, seed=n + rows + 1)
    oc = _launch_band_attention(q, k, vv, heads, "streamed", rows=rows)
    torch.cuda.synchronize()
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    ref = area_attention_fused_plain(q, k, vv, heads)
    for got, want in ((o, o_ref), (v, v_ref), (oc, ref)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        assert (got.float() - want.float()).abs().max().item() <= tol


def _yolov12_bands(scale):
    """(G, N, C, heads) of yolov12's layers 6 and 8 at batch 1, 160^2 to
    1280^2 in steps of 32, each band once."""
    _, width, max_ch = YOLOV12_SCALES[scale]
    out = []
    for imgsz in range(160, 1281, 32):
        for c2, stride, area in ((512, 16, 4), (1024, 32, 1)):
            c = scale_channels(c2, width, max_ch) // 2
            tokens = (imgsz // stride) ** 2
            n = tokens // area if tokens % area == 0 else tokens
            band = (area if tokens % area == 0 else 1, n, c, c // 32)
            if band not in out:
                out.append(band)
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("scale", list(YOLOV12_SCALES))
def test_streamed_kernels_at_every_yolov12_band(cuda, scale, dtype, tol):
    """Kernels A and C forced onto the streamed path at every band of a
    yolov12 scale at 160^2-1280^2 (batch 1, the plan's query rows), on a
    side stream, against the plain version."""
    side = torch.cuda.Stream()
    for g, n, c, heads in _yolov12_bands(scale):
        x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=n + c)
        q, k, v = _qkv_inputs(g, n, c, dtype, cuda, seed=n + c + 1)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            o, ov = _launch_qkv_attention(x, w, b, heads, "streamed")
            oc = _launch_band_attention(q, k, v, heads, "streamed")
        torch.cuda.current_stream().wait_stream(side)
        o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
        ref = area_attention_fused_plain(q, k, v, heads)
        for got, want in ((o, o_ref), (ov, v_ref), (oc, ref)):
            err = (got.float() - want.float()).abs().max().item()
            assert bool(torch.isfinite(got).all()) and err <= tol, (
                scale, g, n, c, err)


def test_streamed_kernels_refuse_what_they_cannot_map(cuda):
    """No fallback: a query-row count the kernels do not take, or a base the
    tensor map cannot be encoded over (TMA needs 16 bytes of alignment),
    fails the C entry before any launch and the wrapper raises; an f32
    tensor off a 16-byte boundary is refused by the wrapper."""
    lib = build.load()
    q, k, v = _qkv_inputs(2, 100, 64, torch.float32, cuda, seed=9)
    o = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    scale = 32 ** -0.5
    for dtype, rows, heads in ((0, 48, 2), (0, 128, 2), (1, 32, 2),
                               (0, 64, 1), (1, 128, 1), (0, 32, 4)):
        # heads of 64 take 32 rows in f32 and 64 in bf16; 16 no kernel
        code = lib.yolou_band_attention_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 2, 100,
            64, heads, dtype, rows, scale, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(lib, code, "streamed kernel")
    code = lib.yolou_band_attention_stream(
        q.data_ptr() + 4, k.data_ptr(), v.data_ptr(), o.data_ptr(), 2, 99,
        64, 2, 0, 64, scale, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib, code, "streamed kernel")
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        area_attention_fused(shifted, k, v, 2)


# ------------------------------------- kernel A's short path (<= 64 tokens)

# G, N, C, heads: the 160^2 bands at batch 16, 8 and 128 (yolov12n's layers
# 6 and 8), N = 1, 16 and 64, G not a multiple of the bands a tile packs
# (P = 64 // N), the largest C at N = 25 (yolov12x's 384) and a C past every
# yolov12 width (the ring refills); heads of 48 and 16 (padded) below
SHORT_CASES = [(64, 25, 64, 2), (16, 25, 128, 4), (32, 25, 64, 2),
               (8, 25, 128, 4), (512, 25, 64, 2), (128, 25, 128, 4),
               (67, 1, 32, 1), (9, 16, 64, 2), (3, 64, 128, 4),
               (7, 25, 64, 2), (5, 33, 256, 8), (16, 25, 384, 12),
               (3, 25, 896, 28)]
# f32 within 1e-5; bf16 within 2^-7, one bf16 step of an output in [1, 2)
SHORT_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,c,heads", SHORT_CASES)
def test_short_path_matches_plain(cuda, g, n, c, heads, dtype):
    """Kernel A's short path (one device kernel a call: whole bands packed
    to a 64-row tile, projection and attention in one launch) is the plan
    at every band of 64 tokens or fewer, and agrees with the plain
    version."""
    assert attention_plan(g, n, c, dtype).path == "short"
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=g + n + c)
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention"] == 1
    assert kernels.device_counts()["band_attention"] == 1
    kind = "f32" if dtype == torch.float32 else "bf16"
    assert kernels.path_counts() == {f"short {kind}": 1}
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    for got, want in ((o, o_ref), (v, v_ref)):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs().max().item()
        assert err <= SHORT_TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 48])
def test_short_path_at_padded_heads(cuda, hd, dtype):
    """Heads of 16 and 48 at the 160^2 band, padded to 32 and 64 by the
    wrapper and run on the short path with the true scale."""
    x, w, b = _attn_inputs(16, 25, 2 * hd, dtype, cuda, seed=hd)
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, 2)
    torch.cuda.synchronize()
    assert kernels.device_counts()["band_attention"] == 1
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, 2)
    for got, want in ((o, o_ref), (v, v_ref)):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= SHORT_TOL[dtype], err


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("g,n,c,heads", [(64, 25, 64, 2), (16, 25, 128, 4),
                                         (67, 1, 64, 2), (9, 16, 64, 1),
                                         (5, 32, 128, 4), (3, 25, 64, 1)])
def test_short_f32_at_both_tile_rows(cuda, g, n, c, heads, rows):
    """The f32 short kernel forced to tiles of 64 and of 32 rows (the two
    CTA shapes `short_rows` chooses between) at bands of 32 tokens or
    fewer, against the plain version within 1e-5."""
    x, w, b = _attn_inputs(g, n, c, torch.float32, cuda, seed=g + n + rows)
    o, v = _launch_qkv_attention(x, w, b, heads, "short", rows=rows)
    torch.cuda.synchronize()
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    for got, want in ((o, o_ref), (v, v_ref)):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= SHORT_TOL[torch.float32]


# ------------------------------------- kernel C's short path (<= 64 tokens)

# G, N, heads: N from 1 to 64 (P = 64 // N bands a tile, from 64 to 1), G
# not a multiple of P (the last tile partly empty), one to four heads; the
# fine-tune's 160^2 bands and a 2 x 2 mesh's shards
TRAIN_SHORT_CASES = [(67, 1, 1), (35, 2, 2), (11, 7, 3), (9, 16, 4),
                     (5, 25, 2), (3, 32, 1), (2, 33, 4), (3, 48, 2),
                     (3, 64, 3), (64, 25, 2), (16, 25, 4), (32, 25, 2),
                     (8, 25, 4)]


def _short_error(got, want, dtype):
    """max |got - want|, and its bound: f32 1e-5; bf16 2^-7 of the largest
    magnitude (one bf16 step of its outputs)."""
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        return err, 1e-5
    return err, 2.0 ** -7 * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 48, 16])
@pytest.mark.parametrize("g,n,heads", TRAIN_SHORT_CASES)
def test_short_training_path_matches_plain(cuda, g, n, heads, hd, dtype):
    """Kernel C's short path (one device kernel a call: whole bands packed
    to a tile, one softmax pass against the full row's maximum) is the plan
    at every band of 64 tokens or fewer, heads of 32 and 64 and of 48 and
    16 padded inside the kernel, and agrees with the plain version: f32
    within 1e-5, bf16 within 2^-7 of the largest magnitude; the one-head
    entry at one head."""
    c = heads * hd
    hdp = padded_head_dim(hd)
    assert attention_plan(g, n, heads * hdp, dtype, False, hdp).path == \
        "short"
    q, k, v = _qkv_inputs(g, n, c, dtype, cuda, seed=g + n + c)
    kernels.reset_launch_counts()
    o = area_attention_fused(q, k, v, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention_train"] == 1
    kind = "f32" if dtype == torch.float32 else "bf16"
    key = f"short {kind}" + ("" if hd == hdp else " padded")
    assert kernels.path_counts("band_attention_train") == {key: 1}
    got = [(o, area_attention_fused_plain(q, k, v, heads))]
    if heads == 1:
        got.append((area_attention(q, k, v), area_attention_plain(q, k, v)))
        assert kernels.path_counts("band_attention_single") == {key: 1}
    for a, r in got:
        assert a.dtype == dtype and bool(torch.isfinite(a).all())
        err, tol = _short_error(a, r, dtype)
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("rows", [64, 32])
@pytest.mark.parametrize("g,n,heads,hd", [(64, 25, 2, 32), (16, 25, 4, 32),
                                          (67, 1, 2, 32), (9, 16, 1, 64),
                                          (5, 32, 2, 64), (3, 25, 1, 32)])
def test_short_training_f32_at_both_tile_rows(cuda, g, n, heads, hd, rows):
    """The f32 short kernel C forced to tiles of 64 and of 32 rows (the two
    CTA shapes `short_rows` chooses between) at bands of 32 tokens or
    fewer, against the plain version within 1e-5."""
    q, k, v = _qkv_inputs(g, n, heads * hd, torch.float32, cuda,
                          seed=g + n + rows)
    o = _launch_band_attention(q, k, v, heads, "short", rows=rows)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all())
    assert (o - area_attention_fused_plain(q, k, v, heads)).abs().max() \
        <= 1e-5


def test_short_training_entry_refuses_what_it_cannot_run(cuda):
    """No fallback: the short C entry fails before any launch at a band
    longer than its tile, a bf16 tile other than 64 rows, an f32 tile
    other than 64 or 32, another type code, heads neither 32 nor 64 wide,
    G or N out of range, or a base the tensor map cannot be encoded over;
    the wrapper raises on each."""
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    scale = 32 ** -0.5
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        q, k, v = _qkv_inputs(3, 25, 64, dtype, cuda, seed=11)
        o = torch.empty_like(q)
        ptrs = [t.data_ptr() for t in (q, k, v, o)]
        bad = [(3, 65, 64, 2, code, 64), (3, 33, 64, 2, code, 32),
               (3, 25, 64, 2, 2, 64), (3, 25, 96, 2, code, 64),
               (3, 25, 64, 0, code, 64), (0, 25, 64, 2, code, 64),
               (3, 0, 64, 2, code, 64), (70000, 25, 64, 2, code, 64),
               (3, 8, 64, 2, code, 16 if code == 0 else 32)]
        for args in bad:
            status = lib.yolou_band_attention_short(*ptrs, *args, scale,
                                                    stream)
            with pytest.raises(RuntimeError, match="CUDA error"):
                build.check(lib, status, f"short kernel C {args}")
        status = lib.yolou_band_attention_short(
            ptrs[0] + 4, *ptrs[1:], 3, 24, 64, 2, code, 64, scale, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(lib, status, "short kernel C, misaligned")
        shifted = torch.empty(q.numel() + 8, dtype=dtype,
                              device=cuda)[1:1 + q.numel()].view(q.shape)
        with pytest.raises(ValueError, match="16-byte aligned"):
            area_attention_fused(shifted, k, v, 2)


# G, N, C, heads: yolov12n's layers 6 and 8 at 640^2, batch 8 and 16, and
# at 1280^2, batch 8
PROJECTION_CASES = [(32, 400, 64, 2), (8, 400, 128, 4), (64, 400, 64, 2),
                    (16, 400, 128, 4), (32, 1600, 64, 2), (8, 1600, 128, 4)]


@pytest.mark.parametrize("g,n,c,heads", PROJECTION_CASES)
def test_f32_projection_matches_plain_and_addmm(cuda, g, n, c, heads):
    """f32 kernel A's streamed path, whose first launch is the k/v
    projection on register micro-tiles (`kv_projection_f32_kernel`): v (its
    output) against the plain version and against one `torch.addmm` of the
    same columns (TF32 off) within 1e-5, o within 1e-5 of the plain
    version."""
    assert attention_plan(g, n, c, torch.float32).streamed
    x, w, b = _attn_inputs(g, n, c, torch.float32, cuda, seed=n + c)
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, heads)
    torch.cuda.synchronize()
    assert kernels.device_counts()["band_attention"] == 2
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    kv = torch.addmm(b[c:], x.view(-1, c), w[:, c:]).view(g, n, 2 * c)
    for got, want in ((v, v_ref), (v, kv[..., c:]), (o, o_ref)):
        assert bool(torch.isfinite(got).all())
        assert (got - want).abs().max().item() <= 1e-5


# G, N, C, heads: yolov12s / x's layer 8 at 640^2 (256, 384 channels: a
# ring of 4 stages), twice the ring's channels (8 stages), heads of 64 at
# layers 6 and 8's widths, and widths off a 64-channel stage (32: one head,
# 96: three), G N never a multiple of the 64-token tile
BF16_PROJECTION_CASES = [(8, 400, 256, 8), (8, 400, 384, 12),
                         (3, 100, 512, 16), (32, 400, 64, 1),
                         (8, 400, 128, 2), (2, 400, 32, 1), (5, 77, 96, 3)]


@pytest.mark.parametrize("g,n,c,heads", BF16_PROJECTION_CASES)
def test_bf16_projection_matches_plain_and_addmm(cuda, g, n, c, heads):
    """bf16 kernel A's streamed path, whose first launch is the k/v
    projection on wgmma from TMA-fed shared memory
    (`kv_projection_wgmma_kernel`): v (its output) against the plain
    version within one bf16 step at its largest magnitude (2**-7 max|v|:
    one f32 sum in another order, rounded once), against one bf16
    `torch.addmm` of the same columns within two (the call rounds the bias
    to bf16 first); o within the bf16 attention tolerance, 2e-2."""
    x, w, b = _attn_inputs(g, n, c, torch.bfloat16, cuda, seed=n + c + g)
    kernels.reset_launch_counts()
    o, v = _launch_qkv_attention(x, w, b, heads, "streamed")
    torch.cuda.synchronize()
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    step = 2.0 ** -7 * v_ref.float().abs().max().item()
    kv = torch.addmm(b[c:].to(torch.bfloat16), x.view(-1, c),
                     w[:, c:]).view(g, n, 2 * c)
    assert bool(torch.isfinite(v).all() and torch.isfinite(o).all())
    assert (v.float() - v_ref.float()).abs().max().item() <= step
    assert (v.float() - kv[..., c:].float()).abs().max().item() <= 2 * step
    assert (o.float() - o_ref.float()).abs().max().item() <= 2e-2


# ---------------------------------------------- kernel A's wide form, any C

# G, N, C, heads, type: the widths where the q-projecting streamed kernel
# passes a block (bf16 from 928 channels at heads of 32 and 512 at heads of
# 64, f32 from 1344 and 640): A2C2f(1856, 1856)'s c_ 928, f32's first
# refused width, AAttn(512, 8) and AAttn(640, 10); C = 2048 at heads of 64
WIDE_CASES = [(4, 400, 928, 29, torch.bfloat16),
              (4, 400, 1344, 42, torch.float32),
              (4, 400, 512, 8, torch.bfloat16),
              (4, 400, 640, 10, torch.float32),
              (2, 400, 2048, 32, torch.bfloat16),
              (2, 400, 2048, 32, torch.float32),
              (3, 77, 960, 30, torch.bfloat16)]
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _type(dtype):
    return "f32" if dtype == torch.float32 else "bf16"


@pytest.mark.parametrize("g,n,c,heads,dtype", WIDE_CASES,
                         ids=lambda v: str(v).replace("torch.", ""))
def test_wide_form_matches_plain(cuda, g, n, c, heads, dtype):
    """Kernel A at widths whose q-projecting kernel would not fit a block
    takes the wide form, one launch of two device kernels counted on path
    "wide" (`kernels.path_counts`); o and v within the plain version's
    tolerances (f32 1e-4, bf16 2e-2), and the streamed path forced there is
    refused by name."""
    hd = c // heads
    plan = attention_plan(g, n, c, dtype, hd=hd)
    assert plan.path == "wide" and plan.launches == 2 and plan.streamed
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=c + heads)
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention"] == 1
    assert kernels.device_counts()["band_attention"] == 2
    assert kernels.path_counts() == {f"wide {_type(dtype)}": 1}
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    assert bool(torch.isfinite(o).all() and torch.isfinite(v).all())
    assert (o.float() - o_ref.float()).abs().max().item() <= ATTN_TOL[dtype]
    assert (v.float() - v_ref.float()).abs().max().item() <= ATTN_TOL[dtype]
    with pytest.raises(ValueError, match="than a block has"):
        _launch_qkv_attention(x, w, b, heads, "streamed")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("g,n,heads,hd,widest", [
    (3, 1, 1, 32, False), (2, 65, 2, 32, False), (2, 129, 3, 32, False),
    (4, 400, 2, 64, False), (1, 1025, 4, 32, False), (2, 200, 3, 64, False),
    (2, 400, 8, 32, True), (3, 129, 3, 32, True)])
def test_wide_form_forced_at_any_band(cuda, g, n, heads, hd, widest, dtype):
    """The wide form forced where the plan takes another path: any N (one
    token, ragged key tiles and query blocks), heads of 32 and 64, at the
    planned query rows and (`widest`) at the largest CTA (bf16 128 rows, two
    consumer warpgroups; f32 64); within the plain version's tolerances,
    q's rounding the plain version's."""
    c = hd * heads
    rows = (128 if dtype == torch.bfloat16 else 64) if widest else None
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=n + c)
    o, v = _launch_qkv_attention(x, w, b, heads, "wide", rows=rows)
    torch.cuda.synchronize()
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    assert (o.float() - o_ref.float()).abs().max().item() <= ATTN_TOL[dtype]
    assert (v.float() - v_ref.float()).abs().max().item() <= ATTN_TOL[dtype]


def test_wide_form_at_padded_heads(cuda):
    """Heads of 48 at a width whose padded form (heads x 64) is wide: the
    wrapper pads x and the weight (`pad_qkv_projection`), the wide form
    runs at 64 a head with the true scale, and cuts the heads back."""
    for dtype, c, heads in ((torch.bfloat16, 480, 10),
                            (torch.float32, 624, 13)):
        assert attention_plan(2, 400, heads * 64, dtype, hd=64).path == "wide"
        x, w, b = _attn_inputs(2, 400, c, dtype, cuda, seed=c)
        kernels.reset_launch_counts()
        o, v = area_attention_qkv_fused(x, w, b, heads)
        torch.cuda.synchronize()
        assert kernels.path_counts() == {f"wide {_type(dtype)}": 1}
        o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
        assert (o.float() - o_ref.float()).abs().max().item() <= \
            ATTN_TOL[dtype]
        assert (v.float() - v_ref.float()).abs().max().item() <= \
            ATTN_TOL[dtype]


def test_wide_entry_refuses_what_it_cannot_run(cuda):
    """The wide form's C entry refuses, before any launch, query rows its
    attention does not take (heads of 64: f32 32, bf16 64) and a missing q
    scratch; kernel C has no wide form."""
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, code, rows, heads in ((torch.float32, 0, 64, 10),
                                     (torch.float32, 0, 48, 20),
                                     (torch.bfloat16, 1, 128, 10),
                                     (torch.bfloat16, 1, 32, 20)):
        x, w, b = _attn_inputs(2, 100, 640, dtype, cuda, seed=rows)
        o, v, k, q = (torch.empty_like(x) for _ in range(4))
        got = lib.yolou_band_attention_qkv_wide(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
            v.data_ptr(), k.data_ptr(), q.data_ptr(), 2, 100, 640, heads,
            code, rows, (640 // heads) ** -0.5, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(lib, got, "wide form")
    got = lib.yolou_band_attention_qkv_wide(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(), v.data_ptr(),
        k.data_ptr(), None, 2, 100, 640, 20, 1, 64, 32 ** -0.5, stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib, got, "wide form")
    q, k, v = _qkv_inputs(2, 100, 64, torch.float32, cuda, seed=9)
    with pytest.raises(ValueError, match="path must be one of"):
        _launch_band_attention(q, k, v, 2, "wide")


# ------------------------------------------------- heads of any width

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g,n,heads", [(3, 25, 2), (2, 400, 1),
                                       (1, 1937, 2)])
@pytest.mark.parametrize("hd", [16, 40, 48, 64])
def test_attention_at_any_head_width(cuda, hd, g, n, heads, dtype, tol):
    """Kernels A and C and the single-head entry at heads of 16, 40, 48 and
    64 (padded to 32 or 64 in the wrapper, the true scale kept) on the path
    the plan gives, then kernels A and C on the streamed path and, where the
    band is 64 tokens or fewer, the short one, against the plain version
    over the unpadded operands within its tolerance."""
    c = heads * hd
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=n + hd)
    q, k, v = _qkv_inputs(g, n, c, dtype, cuda, seed=n + hd + 1)
    kernels.reset_launch_counts()
    o, ov = area_attention_qkv_fused(x, w, b, heads)
    oc = area_attention_fused(q, k, v, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention"] == 1
    assert kernels.launch_counts()["band_attention_train"] == 1
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    ref = area_attention_fused_plain(q, k, v, heads)
    got = [(o, o_ref), (ov, v_ref), (oc, ref)]
    if heads == 1:
        got.append((area_attention(q, k, v), area_attention_plain(q, k, v)))
    hdp = padded_head_dim(hd)
    xp, wp, bp = pad_qkv_projection(x, w, b, heads, hdp)
    qp, kp, vp = (pad_heads(t, heads, hdp) for t in (q, k, v))
    for path in ["streamed"] + (["short"] if n <= 64 else []):
        po, pv = _launch_qkv_attention(xp, wp, bp, heads, path,
                                       scale=hd ** -0.5)
        pc = _launch_band_attention(qp, kp, vp, heads, path,
                                    scale=hd ** -0.5)
        got += [(cut_heads(po, heads, hd), o_ref),
                (cut_heads(pv, heads, hd), v_ref),
                (cut_heads(pc, heads, hd), ref)]
    torch.cuda.synchronize()
    for a, r in got:
        assert a.dtype == dtype and a.shape == r.shape
        assert bool(torch.isfinite(a).all())
        assert (a.float() - r.float()).abs().max().item() <= tol


@pytest.mark.parametrize("hd", [16, 48])
def test_attention_gradients_at_other_head_widths(cuda, hd):
    """Kernels A and C at two heads of 16 and of 48, f32: the gradients
    against autograd through the plain version within 1e-4."""
    c = 2 * hd
    x, w, b = _attn_inputs(3, 100, c, torch.float32, cuda, seed=hd)
    q, k, v = _qkv_inputs(3, 100, c, torch.float32, cuda, seed=hd + 1,
                          grad=True)
    for t in (x, w, b):
        t.requires_grad_()
    rng = np.random.default_rng(hd)
    do, dv = (torch.tensor(rng.normal(size=x.shape), dtype=torch.float32,
                           device=cuda) for _ in range(2))
    got = torch.autograd.grad(area_attention_qkv_fused(x, w, b, 2),
                              (x, w, b), (do, dv))
    got += torch.autograd.grad(area_attention_fused(q, k, v, 2), (q, k, v),
                               do)
    want = torch.autograd.grad(area_attention_qkv_fused_plain(x, w, b, 2),
                               (x, w, b), (do, dv))
    want += torch.autograd.grad(area_attention_fused_plain(q, k, v, 2),
                                (q, k, v), do)
    for a, r in zip(got, want):
        assert (a - r).abs().max().item() <= 1e-4


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,c_,c2,n_stages,area,heads", [
    ((2, 10, 10, 32), 16, 32, 1, 4, 1),        # a head of 16, padded to 32
    ((1, 20, 20, 96), 48, 96, 1, 1, 1),        # A2C2f(96, 96): one of 48
    ((2, 12, 12, 40), 80, 96, 2, 4, 2),        # two heads of 40
    ((1, 16, 16, 64), 64, 64, 5, 1, 2),        # five stages
    ((2, 20, 20, 128), 128, 128, 8, 4, 4),     # eight
])
def test_a2c2f_at_any_head_width_and_stage_count(cuda, shape, c_, c2,
                                                 n_stages, area, heads,
                                                 dtype, tol):
    """Heads of 16, 48 and 40 (padded by the wrapper to 32 / 64 / 64, the
    true scale kept) and 5 or 8 stages, in both types, against the plain
    version over the unpadded weights; one launch each."""
    x, ws = _a2c2f_inputs(shape, c_, c2, n_stages, dtype, cuda,
                          seed=c_ + n_stages)
    kernels.reset_launch_counts()
    out = a2c2f_fused(x, ws, n_stages, area, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["a2c2f"] == 1
    ref = a2c2f_fused_plain(x, ws, n_stages, area, heads)
    assert out.dtype == dtype and out.shape == shape[:3] + (c2,)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert ref.float().abs().max().item() > 0.05


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("shape,c_,c2,n_stages,area,heads,hid", [
    ((1, 9, 7, 24), 32, 48, 1, 1, 1, None),    # 63 tokens: ragged tiles
    ((2, 10, 10, 24), 64, 48, 1, 4, 2, None),  # bands of 25
    ((2, 8, 8, 3), 18, 45, 2, 4, 1, 38),       # cin 3, c_ 18, MLP 38, c2 45
    ((1, 10, 10, 24), 48, 36, 1, 1, 1, None),  # a head of 48 (layout 64)
    ((2, 13, 11, 32), 128, 64, 1, 1, 2, None),  # two heads of 64
    ((1, 20, 20, 64), 64, 64, 2, 1, 2, 76),    # 400 tokens, 7 key tiles
    ((3, 12, 20, 64), 96, 96, 1, 4, 3, None),  # bands of 60, 3 heads
])
def test_a2c2f_f32_at_each_layout(cuda, tile, shape, c_, c2, n_stages, area,
                                  heads, hid):
    """The register-tiled f32 kernel forced onto each token tile (64: one
    key group; 32: two, merged) at head widths 32 and 64, ragged token
    tiles and bands, ragged key tiles (one band past 64 keys), and widths
    off a multiple of 4 (padded by the wrapper); within 1e-4 of the plain
    version."""
    x, ws = _a2c2f_inputs(shape, c_, c2, n_stages, torch.float32, cuda,
                          seed=sum(shape) + tile, hid=hid)
    with torch.no_grad():
        out = _launch_a2c2f(x, ws, n_stages, area, heads, tile=tile)
        torch.cuda.synchronize()
        ref = a2c2f_fused_plain(x, ws, n_stages, area, heads)
    assert out.shape == shape[:3] + (c2,) and bool(torch.isfinite(out).all())
    assert (out - ref).abs().max().item() <= 1e-4
    assert ref.abs().max().item() > 0.05


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("shape,c_,c2,n_stages,area,heads,hid", [
    ((1, 9, 7, 24), 32, 48, 1, 1, 1, None),    # 63 tokens: ragged tiles
    ((2, 10, 10, 24), 64, 48, 1, 4, 2, None),  # bands of 25
    ((2, 8, 8, 3), 18, 45, 2, 4, 1, 48),       # cin 3, c_ 18, c2 45
    ((1, 10, 10, 24), 48, 36, 1, 1, 1, None),  # a head of 48 (layout 64)
    ((2, 13, 11, 32), 128, 64, 1, 1, 2, None),  # two heads of 64
    ((1, 20, 20, 64), 64, 64, 2, 1, 2, 80),    # 400 tokens, 4 key tiles
    ((3, 12, 20, 64), 96, 96, 1, 4, 3, None),  # bands of 60, 3 heads
])
def test_a2c2f_bf16_at_each_token_tile(cuda, tile, shape, c_, c2, n_stages,
                                       area, heads, hid):
    """The wgmma kernel forced onto each token tile (64 rows, or 32 of the
    64-row wgmma tiles) at head widths 32 and 64, ragged token tiles,
    bands and key tiles, and widths off a multiple of 8 (padded by the
    wrapper); within 2e-2 of the plain version."""
    x, ws = _a2c2f_inputs(shape, c_, c2, n_stages, torch.bfloat16, cuda,
                          seed=sum(shape) + tile, hid=hid)
    with torch.no_grad():
        out = _launch_a2c2f(x, ws, n_stages, area, heads, tile=tile)
        torch.cuda.synchronize()
        ref = a2c2f_fused_plain(x, ws, n_stages, area, heads)
    assert out.shape == shape[:3] + (c2,) and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert ref.float().abs().max().item() > 0.05


# ------------------------------- heads padded inside kernel C (TMA fills)

def _unswizzle(raw, rows, row_bytes):
    """A TMA box as it landed in shared memory (`rows` rows of `row_bytes`,
    the 128-byte swizzle at 128-byte rows: 16-byte chunk c of row r at c ^
    (r % 8); the 64-byte one at 64-byte rows: c ^ ((r // 2) % 4)) back in
    row order, as (rows, row_bytes) uint8."""
    raw = raw.view(torch.uint8).reshape(rows, row_bytes // 16, 16).cpu()
    out = torch.empty_like(raw)
    for r in range(rows):
        for c in range(row_bytes // 16):
            x = c ^ (r % 8) if row_bytes == 128 else c ^ ((r // 2) % 4)
            out[r, c] = raw[r, x]
    return out.reshape(rows, row_bytes)


@pytest.mark.parametrize("dtype,hd,cols,col0", [
    (torch.bfloat16, 48, 64, 0), (torch.bfloat16, 16, 32, 0),
    (torch.float32, 16, 32, 0), (torch.float32, 48, 32, 32),
    (torch.float32, 16, 32, 32), (torch.bfloat16, 96, 64, 64)])
def test_head_map_boxes_fill_zeros_past_the_head(cuda, dtype, hd, cols,
                                                 col0):
    """`cuTensorMapEncodeTiled` takes a box wider than the head's hd
    channels (its inner dimension), and one that starts past them, and TMA
    fills every channel past hd with zeros: boxes of 64 bf16 channels over
    heads of 48 and at channel 64 of heads of 96, 32 over 16 in both types,
    f32 boxes at channel 32 of heads of 48 (16 real, 16 zero) and of 16 (all
    zero); the rows of one head of one band of a (G, N, heads hd) tensor,
    swizzled as the kernels read them."""
    lib = build.load()
    g, n, heads, head, band = 3, 25, 3, 1, 2
    elt = 2 if dtype == torch.bfloat16 else 4
    src = torch.tensor(np.random.default_rng(hd + col0).normal(
        size=(g, n, heads * hd)), dtype=dtype, device=cuda)
    dst = torch.full((n * cols,), float("nan"), device=cuda).to(dtype)
    code = lib.yolou_tma_head_box(
        src.data_ptr(), dst.data_ptr(), g, n, heads, hd, _DTYPE[dtype], cols,
        col0, head, band, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "head map box")
    torch.cuda.synchronize()
    got = _unswizzle(dst, n, cols * elt).view(dtype)
    want = torch.zeros(n, cols, dtype=dtype)
    real = max(0, min(cols, hd - col0))
    want[:, :real] = src[band, :, head * hd + col0:head * hd + col0 + real]
    assert torch.equal(got, want)


_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
# widths kernel C pads itself (`in_kernel_pad`), 8 to 120, both types
PAD_WIDTHS = [8, 16, 24, 40, 48, 56, 72, 96, 120]
PAD_TOL = {torch.float32: 2e-6, torch.bfloat16: 2.0 ** -7}


def _device_kernels(fn):
    """The names of the device kernels torch.profiler records in one call
    of `fn` (after one call outside the trace); a trace that comes back with
    no device event at all (seen on a process's first trace) is taken
    again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            return names
    return names


def _pad_error(got, want, dtype):
    """max |got - want| and its bound, `PAD_TOL` of the largest output."""
    err = (got.float() - want.float()).abs().max().item()
    return err, PAD_TOL[dtype] * want.float().abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 25, 64, 65, 400])
@pytest.mark.parametrize("hd", PAD_WIDTHS)
def test_padded_heads_are_one_kernel_and_match_plain(cuda, hd, n, dtype):
    """Kernel C at two heads and the one-head entry at every eligible width
    from 8 to 120: padded inside the kernel on the planned path (short to
    64 tokens, streamed past, blocked past 64 channels), counted as
    "<path> <type> padded", one device kernel a call by torch.profiler (no
    copy), within `PAD_TOL` of the plain version's largest output."""
    hdp = padded_head_dim(hd)
    kind = _type(dtype)
    path = attention_plan(3, n, 2 * hdp, dtype, False, hdp).path
    assert path == ("blocked" if hd > 64 else "short" if n <= 64
                    else "streamed")
    q, k, v = _qkv_inputs(3, n, 2 * hd, dtype, cuda, seed=hd * n + 3)
    q1, k1, v1 = (u[..., :hd].contiguous() for u in (q, k, v))
    kernels.reset_launch_counts()
    o = area_attention_fused(q, k, v, 2)
    o1 = area_attention(q1, k1, v1)
    torch.cuda.synchronize()
    for name in ("band_attention_train", "band_attention_single"):
        assert kernels.path_counts(name) == {f"{path} {kind} padded": 1}
    device = _device_kernels(lambda: (area_attention_fused(q, k, v, 2),
                                      area_attention(q1, k1, v1)))
    # the f32 blocked form's padded instance is the cluster kernel's <true>
    assert len(device) == 2 and all(
        "padded" in name or "cluster_kernel<true>" in name
        for name in device), device
    for got, want in ((o, area_attention_fused_plain(q, k, v, 2)),
                      (o1, area_attention_plain(q1, k1, v1))):
        assert got.dtype == dtype and bool(torch.isfinite(got).all())
        err, tol = _pad_error(got, want, dtype)
        assert err <= tol, (err, tol)


@pytest.mark.parametrize("n", [25, 400])
@pytest.mark.parametrize("hd", [48, 96])
def test_padded_heads_gradients_match_autograd(cuda, hd, n):
    """Kernel C at two heads of 48 and of 96, padded inside the kernel, f32:
    the gradients (the plain backward at the true width) against autograd
    through the plain version within 1e-4."""
    q, k, v = _qkv_inputs(2, n, 2 * hd, torch.float32, cuda, seed=hd + n,
                          grad=True)
    do = torch.tensor(np.random.default_rng(hd * n).normal(size=q.shape),
                      dtype=torch.float32, device=cuda)
    kernels.reset_launch_counts()
    got = torch.autograd.grad(area_attention_fused(q, k, v, 2), (q, k, v), do)
    assert all(key.endswith("padded") for key in
               kernels.path_counts("band_attention_train"))
    want = torch.autograd.grad(area_attention_fused_plain(q, k, v, 2),
                               (q, k, v), do)
    for a, r in zip(got, want):
        assert (a - r).abs().max().item() <= 1e-4


@pytest.mark.parametrize("n", [25, 400])
def test_unaddressable_widths_keep_the_copies(cuda, n):
    """bf16 heads of 12 (24-byte rows, no TMA stride) are padded to 32 by
    the wrapper's copies and run the kernel width's own form (path key
    without "padded"), within 2^-7 of the plain version's largest output;
    the padded entries refuse them."""
    q, k, v = _qkv_inputs(3, n, 24, torch.bfloat16, cuda, seed=n)
    kernels.reset_launch_counts()
    o = area_attention_fused(q, k, v, 2)
    path = "short" if n <= 64 else "streamed"
    assert kernels.path_counts("band_attention_train") == {f"{path} bf16": 1}
    err, tol = _pad_error(o, area_attention_fused_plain(q, k, v, 2),
                          torch.bfloat16)
    assert err <= tol, (err, tol)
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    o = torch.empty_like(q)
    for entry, rows in ((lib.yolou_band_attention_short_padded, 64),
                        (lib.yolou_band_attention_stream_padded, 64)):
        code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     3, n, 2, 12, 1, rows, 12 ** -0.5, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(lib, code, "padded entry, heads of 12")


@pytest.mark.parametrize("n", [1, 25, 65, 400])
@pytest.mark.parametrize("hd", [128, 192, 256, 512, 928, 1088])
def test_cluster_form_matches_plain(cuda, hd, n):
    """The f32 blocked form (a cluster of hdp / 64 CTAs; 928 padded to 960
    is 15, past the portable 8; 1088 is two clusters of 9) at two heads and
    one: one device kernel a call, within 2e-6 of the plain version's
    largest output at heads up to 128; a score sums hdp f32 products in
    another order than the plain version's, so past 128 the bound grows as
    sqrt(hdp / 128)."""
    q, k, v = _qkv_inputs(2, n, 2 * hd, torch.float32, cuda, seed=hd + n)
    q1, k1, v1 = (u[..., :hd].contiguous() for u in (q, k, v))
    o = area_attention_fused(q, k, v, 2)
    o1 = area_attention(q1, k1, v1)
    device = _device_kernels(lambda: (area_attention_fused(q, k, v, 2),
                                      area_attention(q1, k1, v1)))
    assert len(device) == 2 and all("cluster" in d for d in device), device
    grow = max(1.0, (padded_head_dim(hd) / 128) ** 0.5)
    for got, want in ((o, area_attention_fused_plain(q, k, v, 2)),
                      (o1, area_attention_plain(q1, k1, v1))):
        assert bool(torch.isfinite(got).all())
        err, tol = _pad_error(got, want, torch.float32)
        assert err <= tol * grow, (err, tol * grow)


# ------------------------------------------ heads wider than 64 (blocked)

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 25, 64, 100, 400])
@pytest.mark.parametrize("hd", [96, 128, 256, 512, 928])
def test_blocked_form_matches_plain(cuda, hd, n, dtype, tol):
    """Heads of 96 (padded to 128), 128, 256, 512 and 928 (padded to 960:
    15 blocks) take the blocked path at every band length, one token
    included: kernel A at two heads (the wide form's
    projection, then kernel C's blocked form: two device kernels), kernel C
    at two heads and the one-head entry, each counted on path "blocked"
    (kernel C's at 96 and 928 "blocked ... padded": padded inside the
    kernel); o and v within the plain versions' tolerances."""
    g, c, t = 3, 2 * hd, _type(dtype)
    hdp = padded_head_dim(hd)
    assert attention_plan(g, n, 2 * hdp, dtype, hd=hdp).path == "blocked"
    x, w, b = _attn_inputs(g, n, c, dtype, cuda, seed=hd + n)
    q, k, v = _qkv_inputs(g, n, c, dtype, cuda, seed=hd + n + 1)
    q1, k1, v1 = (u[..., :hd].contiguous() for u in (q, k, v))
    kernels.reset_launch_counts()
    o, ov = area_attention_qkv_fused(x, w, b, 2)
    oc = area_attention_fused(q, k, v, 2)
    o1 = area_attention(q1, k1, v1)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention"] == 1
    assert kernels.device_counts()["band_attention"] == 2
    # kernel A pads by copies; kernel C inside the kernel at 96 and 928
    assert kernels.path_counts() == {f"blocked {t}": 1}
    for name in ("band_attention_train", "band_attention_single"):
        assert kernels.path_counts(name) == {
            f"blocked {t}" + ("" if hd == hdp else " padded"): 1}
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, 2)
    for got, ref in ((o, o_ref), (ov, v_ref),
                     (oc, area_attention_fused_plain(q, k, v, 2)),
                     (o1, area_attention_plain(q1, k1, v1))):
        assert got.dtype == dtype and got.shape == ref.shape
        assert bool(torch.isfinite(got).all())
        assert (got.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("n", [25, 100])
def test_blocked_form_gradients_match_autograd(cuda, n):
    """Kernels A and C at two heads of 128 (the blocked forward; the
    backward the plain tensor code of every width), f32: the gradients
    against autograd through the plain version within 1e-4."""
    x, w, b = _attn_inputs(2, n, 256, torch.float32, cuda, seed=n)
    q, k, v = _qkv_inputs(2, n, 256, torch.float32, cuda, seed=n + 1,
                          grad=True)
    for u in (x, w, b):
        u.requires_grad_()
    rng = np.random.default_rng(n)
    do, dv = (torch.tensor(rng.normal(size=x.shape), dtype=torch.float32,
                           device=cuda) for _ in range(2))
    kernels.reset_launch_counts()
    got = torch.autograd.grad(area_attention_qkv_fused(x, w, b, 2),
                              (x, w, b), (do, dv))
    got += torch.autograd.grad(area_attention_fused(q, k, v, 2), (q, k, v),
                               do)
    assert kernels.path_counts() == {"blocked f32": 1}
    assert kernels.path_counts("band_attention_train") == {"blocked f32": 1}
    assert kernels.backward_counts() == {"band_attention": 1,
                                         "band_attention_train": 1,
                                         "band_attention_single": 0}
    want = torch.autograd.grad(area_attention_qkv_fused_plain(x, w, b, 2),
                               (x, w, b), (do, dv))
    want += torch.autograd.grad(area_attention_fused_plain(q, k, v, 2),
                                (q, k, v), do)
    for a, r in zip(got, want):
        assert (a - r).abs().max().item() <= 1e-4


def test_blocked_entries_refuse_what_they_cannot_run(cuda):
    """The C entries take heads wider than 64 only in multiples of 64 (the
    wrappers pad) and at the blocked form's query rows (f32 32, bf16 64),
    refused before any launch; a forced path other than "blocked" at such
    heads, and "blocked" at heads of 64, are refused by name."""
    lib = build.load()
    stream = torch.cuda.current_stream().cuda_stream
    q, k, v = _qkv_inputs(2, 100, 384, torch.float32, cuda, seed=7)
    o = torch.empty_like(q)
    for dtype, rows, heads in ((0, 64, 3), (0, 16, 3), (1, 128, 3),
                               (1, 32, 3), (0, 32, 4), (1, 64, 4)):
        # heads of 128: f32 32 rows, bf16 64; heads of 96: no kernel
        code = lib.yolou_band_attention_stream(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 2, 100,
            384, heads, dtype, rows, 128 ** -0.5, stream)
        with pytest.raises(RuntimeError, match="CUDA error"):
            build.check(lib, code, "blocked form")
    x, w, b = _attn_inputs(2, 100, 384, torch.float32, cuda, seed=8)
    kq = [torch.empty_like(x) for _ in range(4)]
    code = lib.yolou_band_attention_qkv_wide(
        x.data_ptr(), w.data_ptr(), b.data_ptr(),
        *(u.data_ptr() for u in kq), 2, 100, 384, 3, 0, 64, 128 ** -0.5,
        stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        build.check(lib, code, "wide form")
    for path in ("streamed", "short"):
        with pytest.raises(ValueError, match="do not take the"):
            _launch_band_attention(q[:, :25].contiguous(),
                                   k[:, :25].contiguous(),
                                   v[:, :25].contiguous(), 3, path)
        with pytest.raises(ValueError, match="do not take the"):
            _launch_qkv_attention(x[:, :25].contiguous(), w, b, 3, path)
    q64, k64, v64 = _qkv_inputs(2, 100, 128, torch.float32, cuda, seed=9)
    with pytest.raises(ValueError, match="do not take the"):
        _launch_band_attention(q64, k64, v64, 2, "blocked")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,c_,area,heads", [
    ((2, 20, 20, 64), 96, 1, 1),       # one head of 96, padded to 128
    ((2, 20, 20, 64), 128, 1, 1),      # one of 128, a band of 400
    ((1, 20, 20, 64), 256, 1, 1),      # one of 256
    ((1, 20, 20, 64), 256, 1, 2),      # two of 128
    ((2, 20, 20, 64), 128, 4, 1),      # bands of 100
    ((1, 4, 100, 64), 128, 1, 1),      # 100 wide: the stencil through L2
    ((1, 10, 40, 64), 256, 1, 2),      # 40 wide at c_ 256: through L2
])
def test_a2c2f_at_heads_wider_than_64(cuda, shape, c_, area, heads, dtype,
                                      tol):
    """The whole block at heads of 96-256 (the blocked form of both
    kernels: a (head, 64-channel block) pair at a time), one launch, in
    both types, the bf16 stencil staged and through L2; within the plain
    version's tolerance over the unpadded weights."""
    x, ws = _a2c2f_inputs(shape, c_, 64, 1, dtype, cuda, seed=c_ + heads)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = a2c2f_fused(x, ws, 1, area, heads)
        torch.cuda.synchronize()
        ref = a2c2f_fused_plain(x, ws, 1, area, heads)
    assert kernels.launch_counts()["a2c2f"] == 1
    assert out.dtype == dtype and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert ref.float().abs().max().item() > 0.05


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("tile", [32, 64])
def test_a2c2f_blocked_at_each_token_tile(cuda, tile, dtype):
    """Both kernels' blocked form forced onto each token tile (f32: both
    layouts, the 32-token tile's two key groups merged), two stages, bands
    of 60 (ragged tiles and key tiles), two heads of 96 (padded to 128);
    f32 within 1e-4, bf16 within 2e-2."""
    x, ws = _a2c2f_inputs((2, 12, 20, 64), 192, 96, 2, dtype, cuda,
                          seed=tile)
    with torch.no_grad():
        out = _launch_a2c2f(x, ws, 2, 4, 2, tile=tile)
        torch.cuda.synchronize()
        ref = a2c2f_fused_plain(x, ws, 2, 4, 2)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert ref.float().abs().max().item() > 0.05


def _nms_inputs(bsz, k, case, device, seed):
    rng = np.random.default_rng(seed)
    if case == "grid":     # IoU exactly 1/2 between lattice neighbours
        xy = np.stack([rng.integers(0, 12, (bsz, k)),
                       rng.integers(0, 4, (bsz, k))], -1).astype(np.float32)
        wh = np.broadcast_to(np.float32([3, 1]), xy.shape)
    else:
        spread = 40.0 if case == "dense" else 600.0
        xy = rng.random((bsz, k, 2), np.float32) * spread
        wh = rng.random((bsz, k, 2), np.float32) * 60 + 4
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.random((bsz, k)) < 0.9
    return (torch.from_numpy(boxes).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("case,thres", [("random", 0.45), ("dense", 0.45),
                                        ("dense", 0.7), ("grid", 0.5)])
@pytest.mark.parametrize("bsz,k", [(1, 1), (2, 63), (3, 64), (2, 65),
                                   (4, 300), (2, 1000), (1, 2048)])
def test_greedy_nms_matches_plain(cuda, bsz, k, case, thres):
    """Identical keep-sets, K a multiple of 64 or not (rows and columns past
    K masked), up to the kernel's 2048; threshold ties on the grid."""
    boxes, valid = _nms_inputs(bsz, k, case, cuda, seed=k + bsz)
    kernels.reset_launch_counts()
    keep = suppress_greedy(boxes, valid, thres)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["greedy_nms"] == 1
    assert torch.equal(keep, suppress_greedy_plain(boxes, valid, thres))


def _nms_layout(bsz, k, case, device):
    """"none": no valid row; "cluster": K copies of one box jittered by a
    few hundredths of a pixel (one kept); "disjoint": K boxes on a grid
    that never touch (all kept); "ties": boxes on a lattice whose
    neighbours overlap with IoU exactly 1/2, at the threshold 0.5."""
    idx = torch.arange(k, dtype=torch.float32)
    if case == "cluster":
        jitter = torch.linspace(0, 0.05, k)
        boxes = torch.stack([jitter, jitter, 100 + jitter, 80 + jitter], -1)
    elif case == "ties":
        x, y = idx % 40, (idx // 40) % 8
        boxes = torch.stack([x, y, x + 3, y + 1], -1)   # IoU 2/4 at x + 1
    else:
        x, y = 10 * (idx % 64), 10 * (idx // 64)
        boxes = torch.stack([x, y, x + 5, y + 5], -1)
    boxes = boxes.expand(bsz, k, 4).contiguous().to(device)
    valid = torch.full((bsz, k), case != "none", device=device)
    return boxes, valid


@pytest.mark.parametrize("case,want", [("none", 0), ("cluster", 1),
                                       ("disjoint", None), ("ties", None)])
@pytest.mark.parametrize("bsz,k", [(1, 1), (2, 63), (2, 65), (16, 2048)])
def test_greedy_nms_edge_layouts(cuda, bsz, k, case, want):
    """No valid row (nothing kept), one cluster (exactly one kept), disjoint
    boxes (all K kept) and threshold ties, K off and on a multiple of 64 up
    to 2048 at 16 images: the keep-sets of the plain version."""
    boxes, valid = _nms_layout(bsz, k, case, cuda)
    thres = 0.5 if case == "ties" else 0.45
    keep = suppress_greedy(boxes, valid, thres)
    assert torch.equal(keep, suppress_greedy_plain(boxes, valid, thres))
    kept = keep.sum(1)
    if want is not None:
        assert bool((kept == min(want, k)).all())
    elif case == "disjoint":
        assert bool((kept == k).all())


def test_greedy_nms_is_one_device_kernel_per_call(cuda):
    """torch.profiler sees exactly one device kernel (and no copy) per
    suppress_greedy call: no hit-matrix pass, no scratch."""
    from torch.profiler import ProfilerActivity, profile
    boxes, valid = _nms_inputs(8, 512, "random", cuda, seed=3)
    suppress_greedy(boxes, valid, 0.45)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            suppress_greedy(boxes, valid, 0.45)
        torch.cuda.synchronize()
    device = [e.name for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 5, device
    assert all("greedy_nms" in name for name in device), device


@pytest.mark.parametrize("case", ["random", "dense", "grid"])
@pytest.mark.parametrize("bsz", [1, 16, 64])
def test_greedy_nms_at_the_largest_k(cuda, bsz, case):
    """K = 2048, the most the kernel takes (32 windows over a cluster of 8
    CTAs, 4 each), at 1, 16 and 64 images (64 clusters: more than the card
    holds at once): the plain version's keep-sets."""
    thres = 0.5 if case == "grid" else 0.45
    boxes, valid = _nms_inputs(bsz, 2048, case, cuda, seed=bsz)
    keep = suppress_greedy(boxes, valid, thres)
    torch.cuda.synchronize()
    assert torch.equal(keep, suppress_greedy_plain(boxes, valid, thres))


def test_greedy_nms_refuses_misaligned_boxes(cuda):
    """The kernel reads each box as one 16-byte load: boxes that do not
    start on a 16-byte boundary are refused, not misread."""
    boxes, valid = _nms_inputs(1, 64, "random", cuda, seed=0)
    flat = torch.empty(64 * 4 + 1, device=cuda)
    moved = flat[1:].view(1, 64, 4)
    moved.copy_(boxes)
    with pytest.raises(ValueError, match="16-byte"):
        suppress_greedy(moved, valid, 0.45)


def test_greedy_nms_refuses_what_it_cannot_run(cuda):
    boxes, valid = _nms_inputs(1, 2049, "random", cuda, seed=0)
    with pytest.raises(ValueError, match="K <="):
        suppress_greedy(boxes, valid, 0.45)
    boxes, valid = _nms_inputs(1, 64, "random", cuda, seed=0)
    with pytest.raises(ValueError, match="one device"):
        suppress_greedy(boxes, valid.cpu(), 0.45)


# ------------------------------------------------- the whole-A2C2f kernel

def _a2c2f_inputs(shape, c_, c2, n_stages, dtype, device, seed, hid=None):
    """x ~ N(0, 1) and weights ~ N(0, 0.5 / sqrt(fan_in)): activations and
    outputs stay of order 1, so the absolute tolerances mean something.
    `hid`: the MLP's width (default 2 c_)."""
    rng = np.random.default_rng(seed)
    hid = 2 * c_ if hid is None else hid

    def mk(*s, gemm=False):
        std = 0.5 / np.sqrt(s[0]) if gemm else 0.1
        t = torch.tensor(rng.normal(0, std, s), dtype=torch.float32,
                         device=device)
        return t.to(dtype) if gemm else t

    ws = [mk(shape[-1], c_, gemm=True), mk(c_)]
    for _ in range(2 * n_stages):
        ws += [mk(c_, 3 * c_, gemm=True), mk(3 * c_), mk(7, 7, c_), mk(c_),
               mk(c_, c_, gemm=True), mk(c_), mk(c_, hid, gemm=True),
               mk(hid), mk(hid, c_, gemm=True), mk(c_)]
    ws += [mk((n_stages + 1) * c_, c2, gemm=True), mk(c2)]
    x = torch.tensor(rng.normal(size=shape), dtype=dtype, device=device)
    return x, ws


A2C2F_CASES = [
    # (B, H, W, cin), c2, n_stages, area, heads
    ((1, 9, 7, 24), 48, 1, 1, 1),        # 63 tokens: a ragged last tile
    ((2, 10, 10, 24), 48, 1, 4, 2),      # bands of 25 tokens, cin 24
    ((1, 8, 8, 32), 64, 2, 1, 3),        # one full wave, 3 heads
    ((3, 12, 20, 64), 96, 2, 4, 4),      # bands of 60: ragged, 4 heads
    ((2, 20, 20, 64), 64, 1, 1, 1),      # the smallest eligible shape
    ((64, 20, 20, 40), 32, 1, 1, 1),     # 1600 tiles: more than one wave
    ((2, 8, 8, 3), 40, 1, 4, 1),         # cin 3 (6-byte rows), c2 40
    ((1, 10, 10, 24), 36, 1, 1, 2),      # c2 36: rows not 16-byte multiples
    ((2, 12, 12, 24), 45, 2, 4, 1),      # c2 odd
    ((1, 16, 16, 40), 72, 1, 1, 2),      # c2 72: a last n8 tile of 8
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,c2,n_stages,area,heads", A2C2F_CASES)
def test_a2c2f_matches_plain(cuda, shape, c2, n_stages, area, heads, dtype,
                             tol):
    """H*W a multiple of the token tile or not, area 1 and 4, 1-4 heads,
    1-2 stages, cin off a multiple of 32 (down to 3, whose rows are not
    16-byte multiples), c2 off a multiple of 16 (even odd), batch 1 and a
    batch whose tiles exceed one co-resident wave; f32 within 1e-4, bf16
    within 2e-2 (outputs of order 1)."""
    x, ws = _a2c2f_inputs(shape, 32 * heads, c2, n_stages, dtype, cuda,
                          seed=sum(shape) + heads)
    kernels.reset_launch_counts()
    out = a2c2f_fused(x, ws, n_stages, area, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["a2c2f"] == 1
    ref = a2c2f_fused_plain(x, ws, n_stages, area, heads)
    assert out.dtype == dtype and out.shape == shape[:3] + (c2,)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert ref.float().abs().max().item() > 0.05          # a live block


def _pad_mlp(ws, n_stages, to):
    """The weight list with every MLP widened to `to` by zero columns of
    mlp1's weight and bias and zero rows of mlp2's, as the bf16 fold does."""
    ws = list(ws)
    for a in range(2 * n_stages):
        i = 2 + 10 * a
        hid = ws[i + 6].shape[1]
        ws[i + 6] = torch.nn.functional.pad(ws[i + 6], (0, to - hid))
        ws[i + 7] = torch.nn.functional.pad(ws[i + 7], (0, to - hid))
        ws[i + 8] = torch.nn.functional.pad(ws[i + 8], (0, 0, 0, to - hid))
    return ws


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,c2,n_stages,area,heads,hid", [
    ((2, 20, 20, 64), 64, 1, 1, 1, 38),        # mlp_ratio 1.2 at c_ 32
    ((2, 40, 40, 128), 128, 2, 4, 2, 76),      # yolov12n L6, mlp_ratio 1.2
    ((2, 20, 20, 256), 256, 2, 1, 4, 153),     # yolov12n L8, mlp_ratio 1.2
    ((1, 8, 8, 32), 64, 1, 1, 1, 200),         # wider than every other tile
])
def test_a2c2f_at_any_mlp_width(cuda, shape, c2, n_stages, area, heads, hid,
                                dtype, tol):
    """The MLP's width from mlp1's weight: f32 as given, bf16 padded to a
    multiple of 16 (the fold's form; unpadded it is refused by name), both
    against the plain version over the unpadded weights."""
    x, ws = _a2c2f_inputs(shape, c2 // 2, c2, n_stages, dtype, cuda,
                          seed=hid, hid=hid)
    ref = a2c2f_fused_plain(x, ws, n_stages, area, heads)
    if dtype == torch.bfloat16:
        with pytest.raises(ValueError, match="multiple of 16"):
            a2c2f_fused(x, ws, n_stages, area, heads)
        ws = _pad_mlp(ws, n_stages, -(-hid // 16) * 16)
    kernels.reset_launch_counts()
    out = a2c2f_fused(x, ws, n_stages, area, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["a2c2f"] == 1
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert ref.float().abs().max().item() > 0.05


@pytest.mark.parametrize("shape,c2,n_stages,layout", [
    ((8, 20, 20, 512), 512, 4, 32),            # yolov12l L8 at 640^2
    ((1, 28, 28, 256), 256, 2, 32),            # yolov12n L8 at 896^2
    ((1, 40, 40, 32), 128, 1, 32),             # a band of 1600 at c_ 64
    ((1, 56, 56, 32), 64, 1, 32),              # 3136 at c_ 32
])
def test_a2c2f_f32_takes_a_smaller_token_tile(cuda, shape, c2, n_stages,
                                              layout):
    """Shapes the gate admits whose f32 CTA of the earlier SIMT kernel
    passed 227 KB at 16 tokens run on the token tile `f32_tile` gives
    (the register-tiled kernel's shared memory does not grow with the
    block), within 1e-4 of the plain version."""
    from yolou_tpu_torch.kernels.a2c2f import a2c2f_mega_eligible, f32_tile
    c_ = c2 // 2
    nb = shape[1] * shape[2]
    assert a2c2f_mega_eligible(shape[1], shape[2], shape[3], c_, 1,
                               c_ // 32)
    assert f32_tile(shape[0], nb, 1) == layout
    x, ws = _a2c2f_inputs(shape, c_, c2, n_stages, torch.float32, cuda,
                          seed=nb)
    out = a2c2f_fused(x, ws, n_stages, 1, c_ // 32)
    torch.cuda.synchronize()
    ref = a2c2f_fused_plain(x, ws, n_stages, 1, c_ // 32)
    assert (out - ref).abs().max().item() <= 1e-4
    assert ref.abs().max().item() > 0.05


@pytest.mark.parametrize("shape,c2,n_stages", [
    ((1, 40, 40, 32), 128, 1),                 # a band of 1600 at c_ 64
    ((2, 56, 56, 32), 64, 2),                  # 3136 at c_ 32, 2 stages
])
def test_a2c2f_bf16_streams_the_longest_bands(cuda, shape, c2, n_stages):
    """The gate's longest bands (modules no yolov12 graph builds), whose
    keys and values no CTA holds, stream through the k/v ring 128 keys a
    tile like every band, at a plan that fits a block; within 2e-2 of the
    plain version."""
    from yolou_tpu_torch.kernels.a2c2f import _SMEM_LIMIT, bf16_plan
    c_ = c2 // 2
    nb = shape[1] * shape[2]
    assert nb > 1024
    assert bf16_plan(c_, c_, 2 * c_, 32, shape[2])[0] <= _SMEM_LIMIT
    x, ws = _a2c2f_inputs(shape, c_, c2, n_stages, torch.bfloat16, cuda,
                          seed=nb)
    kernels.reset_launch_counts()
    out = a2c2f_fused(x, ws, n_stages, 1, c_ // 32)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["a2c2f"] == 1
    ref = a2c2f_fused_plain(x, ws, n_stages, 1, c_ // 32)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert ref.float().abs().max().item() > 0.05


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("shape,c_,c2,area,heads", [
    ((2, 16, 100, 128), 64, 128, 4, 2),     # yolov12n L6's width, a strip
    ((2, 8, 100, 256), 128, 256, 1, 4),     # L8's width, a strip
    ((1, 1, 400, 64), 64, 64, 1, 2),        # one image row
    ((1, 4, 200, 48), 48, 48, 1, 1),        # a head of 48 (layout 64)
])
def test_a2c2f_bf16_takes_images_of_any_width(cuda, tile, shape, c_, c2,
                                              area, heads):
    """Images too wide for the stencil's v rows in a block (the gate admits
    any H x W of an admitted token count): the plan drops the staged rows
    and the stencil reads its taps through L2, at each token tile; within
    2e-2 of the plain version."""
    from yolou_tpu_torch.kernels.a2c2f import bf16_plan
    ca = heads * padded_head_dim(c_ // heads)
    assert bf16_plan(c_, ca, 2 * c_, ca // heads, shape[2])[2] is False
    x, ws = _a2c2f_inputs(shape, c_, c2, 2, torch.bfloat16, cuda,
                          seed=sum(shape) + tile)
    with torch.no_grad():
        out = _launch_a2c2f(x, ws, 2, area, heads, tile=tile)
        torch.cuda.synchronize()
        ref = a2c2f_fused_plain(x, ws, 2, area, heads)
    assert out.shape == shape[:3] + (c2,) and bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert ref.float().abs().max().item() > 0.05


def _seeded_block(c1, c2, mlp_ratio, device, seed):
    """A2C2f(c1, c2, n=1, area=1, mlp_ratio) with `mega_kernel=True` in eval
    mode, BatchNorms carrying random statistics near a scale of 0.3 (the
    block's activations stay of order 1)."""
    from yolou_tpu_torch.models.yolo import init_weights
    from yolou_tpu_torch.nn.attention import A2C2f
    gen = torch.Generator().manual_seed(seed)
    m = init_weights(A2C2f(c1, c2, 1, a2=True, area=1, mlp_ratio=mlp_ratio,
                           mega_kernel=True), gen)
    with torch.no_grad():
        for bn in (t for t in m.modules()
                   if isinstance(t, torch.nn.BatchNorm2d)):
            shape = bn.weight.shape
            bn.weight.copy_(0.3 + 0.03 * torch.randn(shape, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(shape, generator=gen))
            bn.running_mean.copy_(0.1 * torch.randn(shape, generator=gen))
            bn.running_var.copy_(0.5 + 0.5 * torch.rand(shape, generator=gen))
    return m.to(device).eval()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bfloat16", "float32"])
@pytest.mark.parametrize("c1,mlp_ratio", [(512, 4.0), (256, 8.0)],
                         ids=["c_256-mlp4", "c_128-mlp8"])
def test_a2c2f_at_mlps_too_wide_for_the_h_tile(cuda, c1, mlp_ratio, dtype):
    """A2C2f(512, 512, mlp_ratio=4.0) and A2C2f(256, 256, mlp_ratio=8.0) at
    20^2, whose bf16 h tile passes a block: the bf16 plan keeps h in global
    memory; one `a2c2f` launch, no kernel A launch; within the plain
    version's tolerance (f32 1e-4; bf16 2e-2 and 2**-6 of the largest
    output, `chip_smoke.py`'s) and twice it of the staged module."""
    from yolou_tpu_torch.kernels.a2c2f import bf16_plan
    block = _seeded_block(c1, c1, mlp_ratio, cuda, seed=c1)
    c_, heads = c1 // 2, block.num_heads
    ws = block.folded_weights(dtype)
    hid = ws[8].shape[1]
    assert hid == int(c_ * mlp_ratio)
    assert bf16_plan(c_, c_, hid, 32, 20).h_tile is False
    x = torch.tensor(np.random.default_rng(c1).normal(size=(1, c1, 20, 20)),
                     dtype=dtype, device=cuda)
    xl = x.permute(0, 2, 3, 1).contiguous()
    with torch.no_grad():
        ref = a2c2f_fused_plain(xl, ws, 1, 1, heads)
        block.mega_kernel = False
        staged = block(x).permute(0, 2, 3, 1)
        block.mega_kernel = True
        kernels.reset_launch_counts()
        out = block(x).permute(0, 2, 3, 1)
        torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["a2c2f"] == 1 and counts["band_attention"] == 0
    tol = 1e-4
    if dtype == torch.bfloat16:
        tol = min(2e-2, 2.0 ** -6 * ref.float().abs().max().item())
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert (out.float() - staged.float()).abs().max().item() <= 2 * tol
    assert ref.float().abs().max().item() > 0.05


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("shape,c_,c2,n_stages,area,heads,hid", [
    ((2, 20, 20, 64), 256, 128, 2, 4, 8, 1024),      # 2 stages, area 4
    ((1, 16, 100, 64), 128, 64, 1, 1, 2, 1024),      # a strip: L2 stencil
    ((1, 20, 20, 32), 192, 96, 1, 1, 3, 1536),       # heads of 64
])
def test_a2c2f_bf16_h_in_global_memory(cuda, tile, shape, c_, c2, n_stages,
                                       area, heads, hid):
    """The bf16 kernel with h in global memory at each token tile (32-token
    tiles read 64-row boxes of h whose last 32 rows the next tile stores),
    two stages, four bands, a strip whose stencil reads through L2 and
    heads of 64; within 2e-2 of the plain version."""
    from yolou_tpu_torch.kernels.a2c2f import bf16_plan
    ca = heads * padded_head_dim(c_ // heads)
    plan = bf16_plan(c_, ca, hid, ca // heads, shape[2])
    assert plan is not None and plan.h_tile is False
    x, ws = _a2c2f_inputs(shape, c_, c2, n_stages, torch.bfloat16, cuda,
                          seed=hid + tile, hid=hid)
    kernels.reset_launch_counts()
    with torch.no_grad():
        out = _launch_a2c2f(x, ws, n_stages, area, heads, tile=tile)
        torch.cuda.synchronize()
        ref = a2c2f_fused_plain(x, ws, n_stages, area, heads)
    assert bool(torch.isfinite(out).all())
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    assert ref.float().abs().max().item() > 0.05


def test_a2c2f_on_a_side_stream_and_twice(cuda):
    x, ws = _a2c2f_inputs((8, 20, 20, 256), 128, 256, 2, torch.bfloat16, cuda,
                          seed=2)
    ref = a2c2f_fused_plain(x, ws, 2, 1, 4)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        a = a2c2f_fused(x, ws, 2, 1, 4)
        b = a2c2f_fused(x, ws, 2, 1, 4)      # scratch reused back to back
    torch.cuda.current_stream().wait_stream(side)
    assert torch.equal(a, b)
    assert (a.float() - ref.float()).abs().max().item() <= 2e-2


def test_a2c2f_refuses_what_it_cannot_run(cuda):
    """One head of 64 runs (a kernel width), as do cin 16384 in
    f32 (the register-tiled kernel streams every operand) and 5 stages (the
    ABlocks' pointers are a device array), within 1e-4 of the plain
    version; cin 16384 in bf16 runs too (the wgmma kernel streams x in
    boxes with cv1's weight stages), within 2e-2; so does one head of 96
    (padded to 128, the blocked form), within 1e-4."""
    for shape, c_, n, heads in (((1, 8, 8, 32), 64, 1, 1),
                                ((1, 4, 4, 16384), 32, 1, 1),
                                ((1, 4, 4, 32), 32, 5, 1)):
        x, ws = _a2c2f_inputs(shape, c_, 32, n, torch.float32, cuda, 0)
        out = a2c2f_fused(x, ws, n, 1, heads)
        ref = a2c2f_fused_plain(x, ws, n, 1, heads)
        assert (out - ref).abs().max().item() <= 1e-4
    x, ws = _a2c2f_inputs((1, 4, 4, 16384), 32, 32, 1, torch.bfloat16, cuda,
                          0)
    out = a2c2f_fused(x, ws, 1, 1, 1)                  # cin 16384, bf16
    ref = a2c2f_fused_plain(x, ws, 1, 1, 1)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    x, ws = _a2c2f_inputs((1, 4, 4, 32), 96, 32, 1, torch.float32, cuda, 0)
    out = a2c2f_fused(x, ws, 1, 1, 1)                  # one head of 96
    ref = a2c2f_fused_plain(x, ws, 1, 1, 1)
    assert (out - ref).abs().max().item() <= 1e-4
    x, ws = _a2c2f_inputs((1, 4, 4, 32), 32, 32, 1, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="one device"):
        a2c2f_fused(x, [ws[0].cpu(), *ws[1:]], 1, 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        a2c2f_fused(x.transpose(1, 2), ws, 1, 1, 1)
    kernels.reset_launch_counts()
    with pytest.raises(TypeError, match="dtype"):
        a2c2f_fused(x.half(), ws, 1, 1, 1)
    assert kernels.launch_counts()["a2c2f"] == 0


def test_a2c2f_refuses_inputs_that_require_grad(cuda):
    """No backward: an input that requires grad is refused by name before
    any launch; under no_grad the same call launches."""
    x, ws = _a2c2f_inputs((1, 4, 4, 32), 32, 32, 1, torch.float32, cuda, 0)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="a2c2f_fused is not differentiable"):
        a2c2f_fused(x.clone().requires_grad_(), ws, 1, 1, 1)
    assert kernels.launch_counts()["a2c2f"] == 0
    with torch.no_grad():
        out = a2c2f_fused(x.clone().requires_grad_(), ws, 1, 1, 1)
    assert kernels.launch_counts()["a2c2f"] == 1
    assert (out - a2c2f_fused_plain(x, ws, 1, 1, 1)).abs().max().item() <= 1e-4


# ------------------------------------------------- detector stage on the card

class _MemorySplit:
    """A validation split held in memory (no files, no cv2): bright
    ellipses on dark noise, one or two an image, with their masks."""

    def __init__(self, n, hw, seed):
        rng = np.random.default_rng(seed)
        self.imgs = rng.normal(40, 12, (n, hw, hw, 4)).clip(0, 255)
        self.masks = []
        yy, xx = np.mgrid[:hw, :hw]
        for i in range(n):
            ms = []
            for _ in range(rng.integers(1, 3)):
                cy, cx = rng.uniform(0.25 * hw, 0.75 * hw, 2)
                ry, rx = rng.uniform(0.08 * hw, 0.2 * hw, 2)
                inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
                self.imgs[i][inside] = rng.uniform(180, 255, 4)
                ms.append(inside.astype(np.uint8))
            self.masks.append(np.stack(ms))
        self.imgs = self.imgs.astype(np.uint8)

    def __len__(self):
        return len(self.imgs)

    def orig_shape(self, i):
        return self.imgs.shape[1:3]

    def item(self, i):
        return {"img": self.imgs[i], "masks": self.masks[i],
                "cls": np.zeros(len(self.masks[i]), np.int32)}


def _calibrated_yolo(split):
    """Seeded yolov12n-seg weights on the CPU with every BatchNorm set to
    its batch's statistics at std 0.1 over images of `split`, and the
    warm-started head bias: every image gets detections, and f32 on two
    devices agrees (a random init's activations vanish or, at std 1, turn
    chaotic)."""
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.nn.heads import warm_start_detect_bias
    model = build_yolo("yolov12", "n", 1, 4, "segment", device="cpu", seed=0)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    x = torch.from_numpy(split.imgs[:2]).permute(0, 3, 1, 2).float() / 255
    with torch.no_grad():
        for bn in bns:
            bn.weight.fill_(0.1)
            bn.train()
            bn.momentum = 1.0
        model(x)
    for bn in bns:
        bn.eval()
        bn.momentum = 0.03
    return warm_start_detect_bias(model).eval().state_dict()


def test_validation_on_the_card_matches_the_cpu(cuda, monkeypatch):
    """f32, TF32 off: validate_detector on the card and on the CPU over one
    in-memory split (10 images, batch 4, the tail padded): the same number
    of detections per image and the metrics within 1e-4."""
    from yolou_tpu_torch.engine import validator
    from yolou_tpu_torch.models.yolo import build_yolo
    split = _MemorySplit(10, 96, 0)
    sd = _calibrated_yolo(split)
    got, metrics = {}, {}
    detect = validator.detect_batch

    def recorded(*args, **kw):
        out = detect(*args, **kw)
        got[args[0].model[0].conv.weight.device.type].append(out)
        return out

    monkeypatch.setattr(validator, "detect_batch", recorded)
    for dev in (cuda, torch.device("cpu")):
        got[dev.type] = []
        model = build_yolo("yolov12", "n", 1, 4, "segment", device=dev)
        metrics[dev.type] = validator.validate_detector(
            model, sd, split, imgsz=96, batch_size=4)
    counts = {k: np.concatenate([b[..., 6].sum(1) for b in v])[:10]
              for k, v in got.items()}
    assert counts["cuda"].tolist() == counts["cpu"].tolist()
    assert counts["cpu"].min() > 0
    for k, v in metrics["cpu"].items():
        assert abs(metrics["cuda"][k] - v) <= 1e-4, (k, metrics)


def test_model_file_from_the_cpu_loads_on_the_card_bit_identically(cuda,
                                                                   tmp_path):
    """A `.ckpt` written on the CPU, loaded onto the card by `load_model`:
    the f32 forward equals the in-memory model's on the card, bit for bit."""
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.utils.model_io import load_model, save_model
    split = _MemorySplit(2, 64, 1)
    sd = _calibrated_yolo(split)
    model = build_yolo("yolov12", "n", 1, 4, "segment", device="cpu")
    model.load_state_dict(sd, strict=True)
    path = str(tmp_path / "m.ckpt")
    save_model(path, model)
    back = load_model(path)
    assert next(back.parameters()).device.type == "cuda"
    x = torch.from_numpy(split.imgs).to(cuda).permute(0, 3, 1, 2) / 255.0
    with torch.no_grad():
        want = model.to(cuda)(x)
        out = back(x)
    assert torch.equal(out.preds, want.preds)
    assert torch.equal(out.protos, want.protos)


def test_validation_batch_launches_kernels_a_and_b(cuda):
    """bf16 on the card: each validation batch launches kernel A eight times
    (the A2C2f blocks' AAttn at layers 6 and 8) and kernel B once."""
    from yolou_tpu_torch.engine.validator import validate_detector
    from yolou_tpu_torch.models.yolo import build_yolo
    split = _MemorySplit(6, 64, 2)
    model = build_yolo("yolov12", "n", 1, 4, "segment", device=cuda,
                       dtype=torch.bfloat16)
    model.load_state_dict(_calibrated_yolo(split), strict=True)
    kernels.reset_launch_counts()
    validate_detector(model, None, split, imgsz=64, batch_size=4)
    counts = kernels.launch_counts()
    assert counts["band_attention"] == 8 * 2 and counts["greedy_nms"] == 2
    assert counts["band_attention_train"] == counts["a2c2f"] == 0
