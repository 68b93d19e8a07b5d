"""PyTorch port: the CUDA kernels against their plain versions on the card,
at shapes off the serving path (ragged bands and candidate counts, one to
many heads, side streams), and the wrappers' refusals.

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
from yolou_tpu_torch.kernels.attention import (
    area_attention, area_attention_fused, area_attention_fused_plain,
    area_attention_plain, area_attention_qkv_fused,
    area_attention_qkv_fused_plain)
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g,n,heads", [(1, 1, 1), (3, 7, 2), (5, 31, 3),
                                       (2, 33, 4), (7, 100, 2), (2, 257, 1),
                                       (200, 64, 2), (1, 513, 2)])
def test_band_attention_matches_plain(cuda, g, n, heads, dtype, tol):
    """Any N >= 1 (ragged last key tile, one or many CTAs per band), one to
    four heads; f32 within 1e-4, bf16 within 2e-2 (outputs of order 1)."""
    x, w, b = _attn_inputs(g, n, 32 * heads, dtype, cuda, seed=g * n + heads)
    kernels.reset_launch_counts()
    o, v = area_attention_qkv_fused(x, w, b, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention"] == 1
    o_ref, v_ref = area_attention_qkv_fused_plain(x, w, b, heads)
    assert o.dtype == v.dtype == dtype and o.shape == v.shape == x.shape
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
    x, w, b = _attn_inputs(2, 16, 64, torch.float32, cuda, seed=4)
    with pytest.raises(ValueError, match="one device"):
        area_attention_qkv_fused(x, w.cpu(), b, 2)


def _qkv_inputs(g, n, c, dtype, device, seed, grad=False):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.normal(size=(g, n, c)), dtype=dtype,
                              device=device, requires_grad=grad)
                 for _ in range(3))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("g,n,heads", [(1, 1, 1), (3, 7, 2), (2, 33, 3),
                                       (2, 257, 4), (1, 513, 2),
                                       (40, 100, 2)])
def test_training_attention_matches_plain(cuda, g, n, heads, dtype, tol):
    """Kernel C off the training shapes: any N >= 1, one to four heads; f32
    within 1e-4, bf16 within 2e-2 (outputs of order 1)."""
    q, k, v = _qkv_inputs(g, n, 32 * heads, dtype, cuda, seed=g * n + heads)
    kernels.reset_launch_counts()
    o = area_attention_fused(q, k, v, heads)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["band_attention_train"] == 1
    ref = area_attention_fused_plain(q, k, v, heads)
    assert o.dtype == dtype and o.shape == q.shape
    assert (o.float() - ref.float()).abs().max().item() <= tol


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


def test_greedy_nms_refuses_what_it_cannot_run(cuda):
    boxes, valid = _nms_inputs(1, 2049, "random", cuda, seed=0)
    with pytest.raises(ValueError, match="K <="):
        suppress_greedy(boxes, valid, 0.45)
    boxes, valid = _nms_inputs(1, 64, "random", cuda, seed=0)
    with pytest.raises(ValueError, match="one device"):
        suppress_greedy(boxes, valid.cpu(), 0.45)
