"""PyTorch port: `metrics/seg.py` against the JAX package on seeded masks,
on the CPU: random masks, empty, full, single-pixel and one-empty pairs.

Dice and the pixel counts are sums of 0/1 products and must agree to 1e-6;
the squared EDT holds integers, exactly; HD95 is a square root and a linear
interpolation in f32, within 1e-5. NaN positions must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.metrics import seg as jseg
from yolou_tpu_torch.metrics import seg


def _pairs(seed=0, h=24, w=20):
    """(pred, target) (10, h, w) f32 in {0, 1} with the special pairs."""
    rng = np.random.default_rng(seed)
    p = (rng.random((10, h, w)) > 0.6).astype(np.float32)
    g = (rng.random((10, h, w)) > 0.5).astype(np.float32)
    p[0] = 0                                   # empty pred
    g[1] = 0                                   # empty target
    p[2] = 0; g[2] = 0                         # both empty
    p[3] = 1                                   # full pred
    p[4] = 1; g[4] = 1                         # both full
    g[5] = 0; g[5, 3, 3] = 1                   # single-pixel target
    p[6] = 0; p[6, 20, 17] = 1; g[6] = 0; g[6, 2, 1] = 1   # two far pixels
    p[7] = 0; p[7, 5:15, 4:12] = 1; g[7] = 0; g[7, 8:20, 6:18] = 1  # blobs
    return p, g


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _same(got, want, atol):
    got, want = got.numpy(), np.asarray(want)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0, equal_nan=True)


@pytest.mark.parametrize("ignore_empty", [False, True])
def test_dice_matches_jax(ignore_empty):
    p, g = _pairs()
    want = jseg.dice_binary(jnp.asarray(p), jnp.asarray(g), ignore_empty)
    got = seg.dice_binary(_t(p), _t(g), ignore_empty)
    _same(got, want, 1e-6)
    if not ignore_empty:      # both empty -> 1, empty target only -> 0
        assert float(got[2]) == 1.0 and float(got[1]) == 0.0
    assert bool(np.isnan(got.numpy()).any()) == ignore_empty
    # trailing axes of any rank, as the evaluator's (B, H, W, 1) masks
    _same(seg.dice_binary(_t(p)[..., None], _t(g)[..., None], ignore_empty),
          want, 1e-6)


def test_precision_recall_counts_match_jax():
    p, g = _pairs(1)
    want = jseg.precision_recall_counts(jnp.asarray(p), jnp.asarray(g))
    got = seg.precision_recall_counts(_t(p), _t(g))
    for a, b in zip(got, want):
        assert a.ndim == 0 and float(a) == float(b)
    assert float(got[0] + got[1]) == float(p.sum())


@pytest.mark.parametrize("case", range(10))
def test_edt_surface_and_percentile_match_jax(case):
    p, _ = _pairs(2)
    m = p[case] > 0.5
    assert np.array_equal(seg._edt_sq_2d(_t(m)).numpy(),
                          np.asarray(jseg._edt_sq_2d(jnp.asarray(m))))
    assert np.array_equal(seg._surface(_t(m)).numpy(),
                          np.asarray(jseg._surface(jnp.asarray(m))))
    vals = np.random.default_rng(case).random(m.shape).astype(np.float32)
    for q in (0.0, 50.0, 95.0, 100.0):
        want = jseg._masked_percentile(jnp.asarray(vals), jnp.asarray(m), q)
        got = seg._masked_percentile(_t(vals).flatten(), _t(m).flatten(), q)
        _same(got, want, 1e-6)
        if m.any():           # numpy's own percentile is the definition
            np.testing.assert_allclose(float(got), np.percentile(vals[m], q),
                                       atol=1e-6)


def test_hd95_matches_jax():
    p, g = _pairs(3)
    want = jseg.hd95_batch(jnp.asarray(p), jnp.asarray(g))
    got = seg.hd95_batch(_t(p), _t(g))
    _same(got, want, 1e-5)
    assert np.isnan(got.numpy()[[0, 1, 2]]).all()       # an empty side
    assert float(got[4]) == 0.0                         # identical masks
    np.testing.assert_allclose(float(got[6]), np.hypot(18, 16), atol=1e-5)
    for i in (5, 7):
        one = seg.hausdorff_distance_95(_t(p[i]), _t(g[i]))
        assert one.ndim == 0
        _same(one, jseg.hausdorff_distance_95(jnp.asarray(p[i]),
                                              jnp.asarray(g[i])), 1e-5)
    _same(seg.hd95_batch(_t(p), _t(g), 50.0),
          jseg.hd95_batch(jnp.asarray(p), jnp.asarray(g), 50.0), 1e-5)


def test_nanmean_matches_jax():
    for vals in ([1.0, np.nan, 3.0], [np.nan, np.nan], [2.0, 4.0]):
        a = np.asarray(vals, np.float32)
        _same(seg.nanmean(_t(a)), jseg.nanmean(jnp.asarray(a)), 1e-7)
