"""PyTorch port: the plain versions of kernels A and B against the TPU
kernels (Pallas interpret mode) and the JAX package's XLA references.

On a CPU tensor each kernel wrapper runs its plain version, which is what
these tests reach; the CUDA kernels are checked against the same plain
versions on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.boxes import box_iou
from yolou_tpu.ops.nms import _suppress_greedy
from yolou_tpu.ops.nms import non_max_suppression as jax_nms
from yolou_tpu.ops.pallas_attn import (_qkv_attn_reference,
                                       area_attention_qkv_fused as jax_qkv)
from yolou_tpu.ops.pallas_nms import suppress_greedy_fused
from yolou_tpu_torch.kernels.attention import (area_attention_qkv_fused,
                                               area_attention_qkv_fused_plain)
from yolou_tpu_torch.kernels.nms import suppress_greedy, suppress_greedy_plain
from yolou_tpu_torch.ops.nms import non_max_suppression


def _attn_inputs(g, n, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, n, c)).astype(np.float32)
    w = (rng.normal(size=(c, 3 * c)) / np.sqrt(c)).astype(np.float32)
    b = rng.normal(0, 0.1, (1, 3 * c)).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("n", [25, 32])
@pytest.mark.parametrize("c,heads", [(64, 2), (128, 4)])
def test_attention_plain_matches_pallas_and_reference_f32(n, c, heads):
    """f32, 1e-5: same math, sums in another order."""
    x, w, b = _attn_inputs(4, n, c, seed=n + c)
    o, v = area_attention_qkv_fused(torch.from_numpy(x), torch.from_numpy(w),
                                    torch.from_numpy(b), heads)
    o_ref, v_ref = _qkv_attn_reference(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(b), heads)
    o_pl, v_pl = jax_qkv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         heads, interpret=True)
    for got, want in ((o, o_ref), (v, v_ref), (o, o_pl), (v, v_pl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=0)


def test_attention_plain_bf16_matches_reference():
    """bf16: both round qkv and the probabilities to bf16 at the same points;
    sums in another order can move an output by one bf16 ulp (~8e-3 at
    magnitude 1), so 1.6e-2."""
    x, w, b = _attn_inputs(4, 25, 64, seed=5)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    o, v = area_attention_qkv_fused_plain(xt, wt, torch.from_numpy(b), 2)
    o_ref, v_ref = _qkv_attn_reference(jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(w, jnp.bfloat16),
                                       jnp.asarray(b), 2)
    assert o.dtype == v.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_ref, np.float32), atol=1.6e-2,
                               rtol=0)
    np.testing.assert_allclose(v.float().numpy(),
                               np.asarray(v_ref, np.float32), atol=1.6e-2,
                               rtol=0)


def test_attention_wrapper_checks_inputs():
    x, w, b = (torch.from_numpy(a) for a in _attn_inputs(2, 8, 64, 0))
    with pytest.raises(ValueError):
        area_attention_qkv_fused(x, w[:, :96].contiguous(), b, 2)
    with pytest.raises(TypeError):
        area_attention_qkv_fused(x, w.double(), b, 2)
    with pytest.raises(ValueError):
        area_attention_qkv_fused(x.transpose(1, 2), w, b, 2)


# ----------------------------------------------------------------- NMS


def _boxes(rng, b, k, case):
    if case == "grid":
        # integer boxes 3 wide on a 1-px lattice: neighbours have IoU
        # exactly 1/2 or 1/5, so thresholds 0.5 / 0.2 sit on ties
        x = rng.integers(0, 12, (b, k)).astype(np.float32)
        y = rng.integers(0, 4, (b, k)).astype(np.float32)
        xy = np.stack([x, y], -1)
        wh = np.broadcast_to(np.float32([3, 1]), xy.shape)
    else:
        spread = 20.0 if case == "dense" else 100.0
        xy = rng.random((b, k, 2)).astype(np.float32) * spread
        wh = rng.random((b, k, 2)).astype(np.float32) * 30 + 1
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("k", [64, 300, 512])
@pytest.mark.parametrize("case,thres", [("random", 0.45), ("dense", 0.45),
                                        ("grid", 0.5), ("grid", 0.2)])
def test_nms_plain_keep_sets_match_pallas(k, case, thres):
    """Identical keep-sets to the TPU kernel's own (division-free) compare;
    on boxes without threshold ties also to the XLA greedy fixpoint."""
    rng = np.random.default_rng(k)
    boxes = _boxes(rng, 2, k, case)
    valid = rng.random((2, k)) < 0.9
    got = suppress_greedy(torch.from_numpy(boxes), torch.from_numpy(valid),
                          thres)
    assert torch.equal(got, suppress_greedy_plain(torch.from_numpy(boxes),
                                                  torch.from_numpy(valid),
                                                  thres))
    pallas = jax.vmap(lambda bx, v: suppress_greedy_fused(
        bx, v, thres, interpret=True))(jnp.asarray(boxes), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    if case != "grid":
        xla = jax.vmap(lambda bx, v: _suppress_greedy(box_iou(bx, bx), v,
                                                      thres))(
            jnp.asarray(boxes), jnp.asarray(valid))
        np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    assert got.any() and not got.all()


@pytest.mark.parametrize("k", [64, 300, 512])
def test_nms_tied_scores_match_jax(k):
    """Many equal scores: candidate order must follow jax.lax.top_k (ties in
    index order), or greedy keep-sets differ."""
    rng = np.random.default_rng(k + 1)
    n = 2 * k
    xy = rng.random((2, n, 2)).astype(np.float32) * 40
    wh = rng.random((2, n, 2)).astype(np.float32) * 20 + 4
    score = rng.choice(np.float32([0.3, 0.6, 0.9]), (2, n, 1))
    coef = rng.normal(size=(2, n, 3)).astype(np.float32)
    pred = np.concatenate([xy, wh, score, coef], -1).astype(np.float32)
    want = jax_nms(jnp.asarray(pred), nc=1, top_k=k, max_det=k)
    got = non_max_suppression(torch.from_numpy(pred), nc=1, top_k=k,
                              max_det=k)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert 0 < int(got.valid.sum()) < 2 * k


def test_nms_matrix_method_matches_jax():
    rng = np.random.default_rng(9)
    xy = rng.random((2, 200, 2)).astype(np.float32) * 60
    wh = rng.random((2, 200, 2)).astype(np.float32) * 20 + 4
    cls = rng.random((2, 200, 3)).astype(np.float32)
    pred = np.concatenate([xy, wh, cls], -1)
    want = jax_nms(jnp.asarray(pred), method="matrix", top_k=128)
    got = non_max_suppression(torch.from_numpy(pred), method="matrix",
                              top_k=128)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
