"""PyTorch port: preprocessing, masks and the Predictor end to end against
the JAX package, f32 on the CPU.

The letterbox and mask resizes follow `jax.image.resize` semantics (an
up-scale interpolates, a down-scale antialiases); the Predictor runs
yolov12n-seg (4 ch, nc=1) at 64^2 on JAX weights (random BN statistics,
warm-started head bias) carried across by `state_dict_from_jax`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.engine.predictor import Predictor as JaxPredictor
from yolou_tpu.ops.letterbox import letterbox_batch as jax_letterbox
from yolou_tpu.ops.masks import process_mask as jax_process_mask
from yolou_tpu.ops.masks import scale_masks as jax_scale_masks
from yolou_tpu_torch.engine.predictor import Predictor
from yolou_tpu_torch.ops.letterbox import letterbox_batch
from yolou_tpu_torch.ops.masks import process_mask, scale_masks

# the same JAX weights and converted port model as the forward-pass tests
from .test_torch_port_slice import IMGSZ, _close, models  # noqa: F401


@pytest.mark.parametrize("hw", [(240, 240), (1024, 1024), (300, 500)])
def test_letterbox_matches_jax(hw):
    """Up-scale, down-scale (antialiased) and non-square to 640."""
    imgs = np.random.default_rng(hw[0]).integers(0, 256, (1, *hw, 4),
                                                 dtype=np.uint8)
    want = jax_letterbox(jnp.asarray(imgs), (640, 640))
    got = letterbox_batch(torch.from_numpy(imgs), (640, 640))
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_process_mask_matches_jax():
    """Masks are thresholded: a pixel whose sigmoid sits within rounding of
    0.5 may flip, so at most 1e-4 of the pixels may differ."""
    rng = np.random.default_rng(4)
    protos = rng.normal(size=(16, 16, 32)).astype(np.float32)
    coefs = rng.normal(0, 0.3, (5, 32)).astype(np.float32)
    xy = rng.random((5, 2)).astype(np.float32) * 40
    boxes = np.concatenate([xy, xy + 20], -1).astype(np.float32)
    want = np.asarray(jax_process_mask(jnp.asarray(protos), jnp.asarray(coefs),
                                       jnp.asarray(boxes), (64, 64)))
    got = process_mask(torch.from_numpy(protos), torch.from_numpy(coefs),
                       torch.from_numpy(boxes), (64, 64)).numpy()
    assert got.shape == want.shape == (5, 64, 64)
    assert np.mean(got != want) <= 1e-4
    assert want.sum() > 0


@pytest.mark.parametrize("hw", [(64, 64), (24, 40)])
def test_scale_masks_matches_jax(hw):
    masks = np.random.default_rng(6).random((3, 40, 40), np.float32)
    want = jax_scale_masks(jnp.asarray(masks), hw)
    got = scale_masks(torch.from_numpy(masks), hw)
    assert got.shape == want.shape == (3,) + hw
    _close(got, want, 1e-5)


def test_predictor_matches_jax(models):
    """Predictor end to end on uint8 arrays, an up-scale bucket of two
    images and a down-scale bucket: same detections (boxes within 1e-3 px of
    f32 rounding), same masks up to 1e-3 of the pixels."""
    jmod, variables, tmod = models
    rng = np.random.default_rng(5)
    imgs = [rng.integers(0, 256, hw + (4,), dtype=np.uint8)
            for hw in ((40, 40), (96, 80), (40, 40))]
    jp = JaxPredictor(jmod, variables, imgsz=IMGSZ, batch_size=2)
    want = jp(imgs)
    got = Predictor(tmod, imgsz=IMGSZ, batch_size=2)(imgs)
    assert len(got) == len(want) == len(imgs)
    for g, w, img in zip(got, want, imgs):
        assert g.path == w.path
        assert len(g) == len(w) > 0
        np.testing.assert_allclose(g.boxes.data, w.boxes.data, atol=1e-3,
                                   rtol=0)
        assert g.masks.data.shape == w.masks.data.shape
        assert g.masks.data.shape[1:] == img.shape[:2]
        assert np.mean(g.masks.data != w.masks.data) <= 1e-3
        assert g.orig_img is img
