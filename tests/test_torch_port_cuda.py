"""PyTorch port: the CUDA kernels against their plain versions on the card,
at shapes off the serving path (ragged bands, token tiles and candidate
counts, one to many heads, more tiles than one co-resident wave, side
streams), and the wrappers' refusals.

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
from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused, a2c2f_fused_plain
from yolou_tpu_torch.kernels.attention import (
    area_attention, area_attention_fused, area_attention_fused_plain,
    area_attention_plain, area_attention_qkv_fused,
    area_attention_qkv_fused_plain, max_tokens)
from yolou_tpu_torch.kernels.nms import suppress_greedy, suppress_greedy_plain

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


# N around the 16-row query tiles and key steps of the tensor-core path
# (and the 32-key tiles of the SIMT path), the 160^2 and 640^2 band lengths,
# and "max", the largest N the wrapper takes at the case's width and type;
# one to four heads, up to 64 bands
TILE_CASES = [(64 if n in (1, 15, 16, 17, 25, 33) else 4 if n in (399, 400)
               else 2, n, heads)
              for n in (1, 15, 16, 17, 25, 33, 399, 400, "max")
              for heads in (1, 2, 4)]


def _band(n, heads, dtype, projection):
    c = 32 * heads
    return (max_tokens(c, dtype, projection) if n == "max" else n), c


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
    x, w, b = _attn_inputs(2, 16, 96, torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="head_dim"):
        area_attention_qkv_fused(x, w, b, 2)          # head_dim 48
    x, w, b = _attn_inputs(1, 1000, 128, torch.float32, cuda, seed=3)
    with pytest.raises(ValueError, match="shared memory"):
        area_attention_qkv_fused(x, w, b, 4)
    n = max_tokens(128, torch.bfloat16) + 1
    x, w, b = _attn_inputs(1, n, 128, torch.bfloat16, cuda, seed=3)
    with pytest.raises(ValueError, match="shared memory"):
        area_attention_qkv_fused(x, w, b, 4)
    x, w, b = _attn_inputs(1, 17, 64, torch.bfloat16, cuda, seed=3)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        area_attention_qkv_fused(shifted.view(x.shape), w, b, 2)
    x, w, b = _attn_inputs(2, 16, 64, torch.float32, cuda, seed=4)
    with pytest.raises(ValueError, match="one device"):
        area_attention_qkv_fused(x, w.cpu(), b, 2)


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
    q, k, v = _qkv_inputs(2, 16, 96, torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="head_dim"):
        area_attention_fused(q, k, v, 2)              # head_dim 48
    q, k, v = _qkv_inputs(1, 1000, 32, torch.float32, cuda, seed=3)
    with pytest.raises(ValueError, match="shared memory"):
        area_attention_fused(q, k, v, 1)
    n = max_tokens(32, torch.bfloat16, projection=False) + 1
    q, k, v = _qkv_inputs(1, n, 32, torch.bfloat16, cuda, seed=3)
    with pytest.raises(ValueError, match="shared memory"):
        area_attention_fused(q, k, v, 1)
    q, k, v = _qkv_inputs(2, 16, 64, torch.float32, cuda, seed=4)
    with pytest.raises(ValueError, match="one device"):
        area_attention_fused(q, k.cpu(), v, 2)
    with pytest.raises(ValueError, match="contiguous"):
        area_attention_fused(q.transpose(0, 1).contiguous().transpose(0, 1),
                             k, v, 2)
    with pytest.raises(TypeError, match="dtype"):
        area_attention_fused(q.half(), k.half(), v.half(), 2)


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


def test_greedy_nms_refuses_what_it_cannot_run(cuda):
    boxes, valid = _nms_inputs(1, 2049, "random", cuda, seed=0)
    with pytest.raises(ValueError, match="K <="):
        suppress_greedy(boxes, valid, 0.45)
    boxes, valid = _nms_inputs(1, 64, "random", cuda, seed=0)
    with pytest.raises(ValueError, match="one device"):
        suppress_greedy(boxes, valid.cpu(), 0.45)


# ------------------------------------------------- the whole-A2C2f kernel

def _a2c2f_inputs(shape, c_, c2, n_stages, dtype, device, seed):
    """x ~ N(0, 1) and weights ~ N(0, 0.5 / sqrt(fan_in)): activations and
    outputs stay of order 1, so the absolute tolerances mean something."""
    rng = np.random.default_rng(seed)

    def mk(*s, gemm=False):
        std = 0.5 / np.sqrt(s[0]) if gemm else 0.1
        t = torch.tensor(rng.normal(0, std, s), dtype=torch.float32,
                         device=device)
        return t.to(dtype) if gemm else t

    ws = [mk(shape[-1], c_, gemm=True), mk(c_)]
    for _ in range(2 * n_stages):
        ws += [mk(c_, 3 * c_, gemm=True), mk(3 * c_), mk(7, 7, c_), mk(c_),
               mk(c_, c_, gemm=True), mk(c_), mk(c_, 2 * c_, gemm=True),
               mk(2 * c_), mk(2 * c_, c_, gemm=True), mk(c_)]
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
    x, ws = _a2c2f_inputs((1, 8, 8, 32), 64, 64, 1, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="head_dim 32"):
        a2c2f_fused(x, ws, 1, 1, 1)                    # one head of 64
    x, ws = _a2c2f_inputs((1, 40, 40, 32), 64, 64, 1, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="shared memory"):
        a2c2f_fused(x, ws, 1, 1, 2)                    # a band of 1600, f32
    x, ws = _a2c2f_inputs((1, 4, 4, 32), 32, 32, 5, torch.float32, cuda, 0)
    with pytest.raises(ValueError, match="at most 4 stages"):
        a2c2f_fused(x, ws, 5, 1, 1)
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
