"""PyTorch port: the evaluator against the JAX package's on a synthetic
dataset directory, f32 on the CPU.

Six images at 64^2 in batches of 4 (the last batch padded), random weights
carried across by `state_dict_from_jax`. `sigmoid > 0.5` turns a 1e-6
difference of a mask logit near 0 into a flipped pixel, so the binary masks
are compared by the share of differing pixels (under 1e-3) and the metrics
with tolerances that a few flipped pixels of a ~4000-pixel image allow:
Dice, precision and recall 2e-3, HD95 0.25 px.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import synthetic
from yolou_tpu.engine.evaluator import Evaluator as JaxEvaluator
from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu_torch.data.decoder_dataset import DecoderDataset
from yolou_tpu_torch.engine.evaluator import Evaluator
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_port_segpp import _draw
from .torch_threads import one_torch_thread  # noqa: F401

SIZE, BATCH = 64, 4
KEYS = {"dice", "hd95", "precision", "recall", "images_per_sec", "n_images"}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("segdata"))
    synthetic.generate(root, {"test": 6}, size=SIZE, seed=5)
    jmod = jsegpp.YOLOSegPP(spec=jax_spec("yolov12", "n", 1, 4, "detect"))
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 4)), train=False))
    v = _draw(shapes, seed=11)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.5 if p[-1].key == "var" else a, v["batch_stats"])
    tmod = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    # random weights give mask logits of one sign: centre them on the first
    # batch through the output bias, on both sides, so that masks have shape
    ds = DecoderDataset(root, "images/test", "masks/test", SIZE)
    with torch.no_grad():
        x = torch.from_numpy(next(ds.batches(BATCH))[0]).permute(0, 3, 1, 2)
        median = float(tmod(x)[0].median())
    bias = v["params"]["decoder"]["output"]["bias"]
    v["params"]["decoder"]["output"]["bias"] = bias - np.float32(median)
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    jev = JaxEvaluator(jmod, v, root, image_size=SIZE, batch_size=BATCH)
    tev = Evaluator(tmod, root, image_size=SIZE, batch_size=BATCH,
                    device="cpu")
    return root, jev, tev


def test_step_matches_jax(setup):
    root, jev, tev = setup
    ds = DecoderDataset(root, "images/test", "masks/test", SIZE)
    imgs, masks, oms, n_real = next(ds.batches(BATCH))
    assert imgs.shape == (BATCH, SIZE, SIZE, 4) and oms is None
    assert n_real == BATCH and masks.shape == (BATCH, SIZE, SIZE, 1)
    want_bin, want_dets = jev._step(jev.variables, jnp.asarray(imgs))
    got_bin, got_dets = tev.step(imgs)
    assert got_bin.shape == (BATCH, SIZE, SIZE, 1)
    assert set(np.unique(got_bin.numpy())) <= {0.0, 1.0}
    flipped = float((got_bin.numpy() != np.asarray(want_bin)).mean())
    assert flipped < 1e-3, flipped
    assert 0.02 < float(got_bin.mean()) < 0.98      # a mask worth comparing
    np.testing.assert_array_equal(got_dets.valid.numpy(),
                                  np.asarray(want_dets.valid))
    np.testing.assert_allclose(got_dets.boxes.numpy(),
                               np.asarray(want_dets.boxes), atol=1e-3)


@pytest.mark.parametrize("with_hd95", [True, False])
def test_evaluate_matches_jax(setup, with_hd95):
    _, jev, tev = setup
    want = jev.evaluate("test", with_hd95=with_hd95)
    got = tev.evaluate("test", with_hd95=with_hd95)
    assert set(got) == set(want) == KEYS
    assert got["n_images"] == want["n_images"] == 6
    assert got["images_per_sec"] > 0
    for k in ("dice", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
        assert 0.0 <= got[k] <= 1.0
    if with_hd95:
        assert abs(got["hd95"] - want["hd95"]) <= 0.25, (got, want)
    else:
        assert np.isnan(got["hd95"]) and np.isnan(want["hd95"])


def test_accumulate_takes_batches_from_memory(setup):
    """The accumulation is split from the dataset: an iterator of (imgs,
    masks, _, n_real) batches gives what `evaluate` gives from the files; no
    batch at all gives NaN Dice and zero counts."""
    root, _, tev = setup
    ds = DecoderDataset(root, "images/test", "masks/test", SIZE)
    batches = list(ds.batches(BATCH))
    assert [b[3] for b in batches] == [4, 2]
    got = tev.accumulate(iter(batches))
    want = tev.evaluate("test")
    for k in KEYS - {"images_per_sec"}:
        assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k]))
    empty = tev.accumulate(iter(()))
    assert np.isnan(empty["dice"]) and np.isnan(empty["hd95"])
    assert empty["n_images"] == 0 and empty["precision"] == 0.0


def test_evaluator_without_a_device_means_the_gpu(setup):
    root, _, tev = setup
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            Evaluator(tev.model, root)
