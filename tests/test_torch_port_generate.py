"""PyTorch port: the objectmap and heatmap generators and the synthetic data
generator against the JAX package, f32 on the CPU.

yolov12n-seg (4 ch, nc=1) at 64^2 on the JAX weights of the forward-pass
tests (random BatchNorm statistics, warm-started head bias) carried across
by `state_dict_from_jax`. Tolerances: raw outputs and objectmaps 1e-4
absolute (logits of order 1 through 22 layers, f32 sums in another order);
splats 1e-5 (a sum of up to 40 Gaussians below 1; the port multiplies the
separable factors); heatmap PNGs, which truncate x255 to uint8, within one
level, and the share of differing pixels under 1 %. The synthetic data
generator is the same code over the same seed: its files are compared byte
for byte.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import synthetic as jax_synthetic
from yolou_tpu.engine import generate as jgen
from yolou_tpu.engine.predictor import Predictor as JaxPredictor
from yolou_tpu.ops.gaussian import splat_heatmaps as jax_splat
from yolou_tpu_torch.data import synthetic
from yolou_tpu_torch.engine import generate
from yolou_tpu_torch.engine.predictor import Predictor
from yolou_tpu_torch.ops.gaussian import splat_heatmaps

from .test_torch_port_slice import IMGSZ, models  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def predictors(models):
    jmod, variables, tmod = models
    return (JaxPredictor(jmod, variables, imgsz=IMGSZ, batch_size=4),
            Predictor(tmod, imgsz=IMGSZ, batch_size=4))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("gen_data"))
    synthetic.generate(r, {"train": 5, "val": 2}, size=IMGSZ, seed=9)
    return r


def test_raw_forward_matches_jax(predictors):
    """Letterbox (a 48x80 image to 64^2) and the forward only."""
    jp, tp = predictors
    imgs = np.random.default_rng(4).integers(0, 256, (2, 48, 80, 4),
                                             dtype=np.uint8)
    want = jp.raw_forward(imgs)
    got = tp.raw_forward(imgs)
    assert len(got.raw) == len(want.raw) == 3
    for g, w in zip(got.raw, want.raw):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(w), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.preds.numpy(), np.asarray(want.preds),
                               atol=1e-3, rtol=0)
    assert got.raw[0].requires_grad is False


def test_objectmap_files_match_jax(predictors, root, tmp_path):
    """Batches of 2 over 5 and 2 images: the same files, the same maps."""
    jp, tp = predictors
    splits = ("train", "val")
    want = jgen.generate_objectmaps(jp, root, str(tmp_path / "jax"),
                                    splits=splits, batch_size=2)
    got = generate.generate_objectmaps(tp, root, str(tmp_path / "port"),
                                       splits=splits, batch_size=2)
    assert got == want == {"train": 5, "val": 2}
    for split in splits:
        names = sorted(os.listdir(tmp_path / "jax" / "objectmap" / split))
        assert names == sorted(
            os.listdir(tmp_path / "port" / "objectmap" / split))
        assert names[0] == f"{split}_0000_20.npy"
        for n in names:
            w = np.load(tmp_path / "jax" / "objectmap" / split / n)
            g = np.load(tmp_path / "port" / "objectmap" / split / n)
            assert g.dtype == np.float32 and g.shape == w.shape == (8, 8)
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=n)
    # the core over arrays in memory gives what the files hold
    imgs = np.random.default_rng(2).integers(0, 256, (3, IMGSZ, IMGSZ, 4),
                                             dtype=np.uint8)
    maps = generate.objectmaps_from_images(tp, imgs)
    assert maps.shape == (3, 8, 8) and maps.dtype == np.float32
    np.testing.assert_allclose(
        maps, np.asarray(jp.raw_forward(imgs).raw[0][..., -1]), atol=1e-4)


def test_splat_matches_jax():
    rng = np.random.default_rng(3)
    b, k, size = 3, 40, 96
    boxes = np.concatenate([rng.uniform(0, size, (b, k, 2)),
                            rng.uniform(0, 30, (b, k, 2))], -1)
    boxes[0, :5, 2:] = 0.5                    # sigma clamped: one pixel
    conf = rng.random((b, k)).astype(np.float32)
    valid = rng.random((b, k)) < 0.7
    valid[2] = False                          # an image without boxes
    args = [boxes.astype(np.float32), conf, valid]
    want = np.asarray(jax_splat(*map(jnp.asarray, args), size=size))
    got = splat_heatmaps(*map(torch.from_numpy, args), size=size)
    assert got.shape == (b, size, size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert float(got[2].abs().max()) == 0.0


def test_heatmap_files_match_jax(predictors, root, tmp_path):
    import cv2
    jp, tp = predictors
    kw = dict(splits=("train",), size=IMGSZ, batch_size=2)
    want = jgen.generate_heatmaps(jp, root, str(tmp_path / "jax"), **kw)
    got = generate.generate_heatmaps(tp, root, str(tmp_path / "port"), **kw)
    assert got == want == {"train": 5}
    d = tmp_path / "{}" / "heatmap" / "train"
    names = sorted(os.listdir(str(d).format("jax")))
    assert names == sorted(os.listdir(str(d).format("port")))
    lit = 0
    for n in names:
        w, g = (cv2.imread(os.path.join(str(d).format(s), n),
                           cv2.IMREAD_UNCHANGED) for s in ("jax", "port"))
        assert g.dtype == np.uint8 and g.shape == w.shape == (IMGSZ, IMGSZ)
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() < 0.01, n
        lit += int((w > 0).sum())
    assert lit > 0                             # the splats are not empty


def test_confidences_match_jax():
    rng = np.random.default_rng(8)
    for shape in ((8, 8), (20, 20), (1, 1)):
        logits = rng.normal(0, 3, shape).astype(np.float32)
        for k_frac in (0.2, 0.05, 1.0):
            assert (generate.spatial_confidence(logits, k_frac)
                    == jgen.spatial_confidence(logits, k_frac))
        assert (generate.argmax_confidence(logits)
                == jgen.argmax_confidence(logits))
    assert generate.spatial_confidence(np.zeros((4, 4))) == 0.5


def _files(top):
    return sorted(os.path.relpath(os.path.join(d, n), top)
                  for d, _, names in os.walk(top) for n in names)


def test_synthetic_writes_the_same_bytes_as_jax(tmp_path):
    splits = {"train": 3, "val": 2, "test": 1}
    ours = synthetic.generate(str(tmp_path / "port"), splits, size=48,
                              seed=13)
    theirs = jax_synthetic.generate(str(tmp_path / "jax"), splits, size=48,
                                    seed=13)
    assert os.path.basename(ours) == os.path.basename(theirs) == "data.yaml"
    maps = {"val_0000": np.arange(36, dtype=np.float32).reshape(6, 6)}
    synthetic.write_objectmaps(str(tmp_path / "port"), maps, "val")
    jax_synthetic.write_objectmaps(str(tmp_path / "jax"), maps, "val")
    files = _files(tmp_path / "jax")
    assert len(files) == 3 * 6 + 2 and "data.yaml" in files
    assert _files(tmp_path / "port") == files
    files.remove("data.yaml")
    for f in files:
        a = (tmp_path / "port" / f).read_bytes()
        assert a == (tmp_path / "jax" / f).read_bytes(), f
    # data.yaml names its own root
    y_port = (tmp_path / "port" / "data.yaml").read_text()
    y_jax = (tmp_path / "jax" / "data.yaml").read_text()
    assert (y_port.replace(str(tmp_path / "port"), "ROOT")
            == y_jax.replace(str(tmp_path / "jax"), "ROOT"))
