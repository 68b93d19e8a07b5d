"""PyTorch port: detection metrics, the composite decoder losses and the
polygon segment utilities against the JAX package's, on the CPU.

`metrics/det.py` and `ops/segments.py` are numpy on both sides: their
results must be exactly equal. The composite losses are f32 torch against
f32 XLA: values and gradients within 1e-6 (relative to magnitude 1 terms),
the Hausdorff-DT loss's gradient within 1e-6 of `jax.grad` with the distance
fields held constant on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.losses import composite as jcomp
from yolou_tpu.metrics import det as jdet
from yolou_tpu.ops import segments as jseg
from yolou_tpu_torch.losses import composite
from yolou_tpu_torch.metrics import det
from yolou_tpu_torch.ops import segments

from .torch_threads import one_torch_thread  # noqa: F401


def _boxes(rng, n, size=64.0):
    xy = rng.uniform(0, size * 0.7, (n, 2))
    wh = rng.uniform(4, size * 0.3, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _cases():
    rng = np.random.default_rng(0)
    gt = np.array([[10, 10, 30, 30], [12, 12, 32, 32]], np.float32)
    quirk = {   # one prediction matching two GTs and two predictions one GT
        "pb": np.array([[11, 11, 31, 31], [10, 10, 30, 30],
                        [12, 12, 32, 31]], np.float32),
        "pc": np.zeros(3), "conf": np.array([0.9, 0.8, 0.8]),
        "gb": gt, "gc": np.zeros(2)}
    empty_pred = {"pb": np.zeros((0, 4), np.float32), "pc": np.zeros(0),
                  "conf": np.zeros(0), "gb": gt, "gc": np.zeros(2)}
    empty_gt = {"pb": gt, "pc": np.zeros(2), "conf": np.array([0.5, 0.4]),
                "gb": np.zeros((0, 4), np.float32), "gc": np.zeros(0)}
    gb = _boxes(rng, 6)
    noisy = gb + rng.normal(0, 2, gb.shape).astype(np.float32)
    classes = {"pb": np.concatenate([noisy, _boxes(rng, 5)]),
               "pc": rng.integers(0, 3, 11).astype(np.float64),
               "conf": np.round(rng.uniform(0, 1, 11), 1),   # ties
               "gb": gb, "gc": rng.integers(0, 3, 6).astype(np.float64)}
    return {"quirk": quirk, "empty_pred": empty_pred, "empty_gt": empty_gt,
            "classes": classes}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_match_predictions_is_jax_exactly(case):
    c = _cases()[case]
    got = det.match_predictions(c["pb"], c["pc"], c["gb"], c["gc"])
    want = jdet.match_predictions(c["pb"], c["pc"], c["gb"], c["gc"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(det.box_iou_np(c["gb"], c["pb"]),
                                  jdet.box_iou_np(c["gb"], c["pb"]))


def test_det_metrics_are_jax_exactly():
    """Several images, three classes (one without GT), confidence ties,
    empty predictions and empty GT, accumulated; and the empty
    accumulator."""
    ours, theirs = det.DetMetrics(nc=4), jdet.DetMetrics(nc=4)
    assert ours.compute() == theirs.compute()
    for c in _cases().values():
        for m in (ours, theirs):
            m.update(c["pb"], c["conf"], c["pc"], c["gb"], c["gc"])
    got, want = ours.compute(), theirs.compute()
    assert got == want and got["map50"] > 0
    rng = np.random.default_rng(3)
    tp = rng.random((20, 10)) > 0.4
    conf = np.round(rng.random(20), 1)
    np.testing.assert_array_equal(det.average_precision(tp, conf, 7),
                                  jdet.average_precision(tp, conf, 7))


def _seg_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (2, 12, 14, 1)).astype(np.float32)
    targets = np.zeros((2, 12, 14, 1), np.float32)
    targets[0, 3:8, 4:10] = 1.0      # the second target is empty
    return logits, targets


@pytest.mark.parametrize("name,kw", [
    ("focal_loss", {}), ("focal_loss", {"alpha": -1.0, "gamma": 1.5}),
    ("hausdorff_dt_loss", {}), ("hausdorff_dt_loss", {"alpha": 1.0}),
    ("yolou_composite_loss", {"hausdorff_weight": 0.3, "focal_weight": 0.5}),
])
def test_composite_losses_and_gradients_match_jax(name, kw):
    logits, targets = _seg_inputs()
    jfn = lambda z: getattr(jcomp, name)(z, jnp.asarray(targets), **kw)
    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    got = getattr(composite, name)(z, torch.from_numpy(targets), **kw)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-6 * max(1.0, abs(float(want)))
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=1e-6)


def test_segments_are_jax_exactly():
    rng = np.random.default_rng(4)
    segs = [rng.random((k, 2)).astype(np.float32) for k in (3, 7, 1)]
    segs.append(np.zeros((0, 2), np.float32))
    for a, b in zip(segments.resample_segments(segs, 50),
                    jseg.resample_segments(segs, 50)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(segments.segments2boxes(segs),
                                  jseg.segments2boxes(segs))
