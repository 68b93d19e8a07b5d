"""PyTorch port: the detector validator and the dataset's validation half
against the JAX package's, f32 on the CPU.

A directory from the port's `data/synthetic.py` (64^2) with two images
cropped to other aspect ratios (48x64, 64x40). The dataset half (`item_rect`,
`collate_padded`, `rect_batch_shape`, `rect_groups`, `batches`) must equal
JAX's byte for byte. `validate_detector` runs yolov12n-seg with random JAX
weights carried across by `state_dict_from_jax`, square (batch 3, the tail
padded) and rect (one group): per-image detections within 1e-4 (pixels of a
64-96 px input, f32 through 22 layers and NMS) and metrics within 1e-6.
Random weights score mAP ~ 0, so a stand-in model whose predictions come from
the split's labels, over one batch holding the whole split, is given to both
validators: there mAP50 > 0.5 and the metrics are equal.
"""

import os
import types

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.data import yolo_dataset as jds
from yolou_tpu.engine import validator as jvalidator
from yolou_tpu.models.yolo import build_yolo as jbuild_yolo
from yolou_tpu_torch.data import synthetic
from yolou_tpu_torch.data import yolo_dataset as tds
from yolou_tpu_torch.engine import validator
from yolou_tpu_torch.models.yolo import build_yolo, parse_model_spec
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

SIZE, N = 64, 8


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The val split's image directory: N synthetic images, two of them
    cropped to 48x64 and 64x40 with their polygons renormalised."""
    root = str(tmp_path_factory.mktemp("detval"))
    synthetic.generate(root, {"val": N}, size=SIZE, seed=7)
    img_dir = os.path.join(root, "images", "val")
    for name, (h, w) in (("val_0001", (48, 64)), ("val_0004", (64, 40))):
        path = os.path.join(img_dir, name + ".png")
        cv2.imwrite(path, cv2.imread(path, cv2.IMREAD_UNCHANGED)[:h, :w])
        label = tds.img2label_path(path)
        rows = []
        for cls, poly in tds.parse_label_file(label):
            poly = np.clip(poly * SIZE / np.array([w, h]), 0, 1)
            rows.append(f"{cls} " + " ".join(f"{c:.6f}"
                                             for c in poly.reshape(-1)))
        with open(label, "w") as f:
            f.write("\n".join(rows) + "\n")
    return img_dir


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_dataset_half_is_jax_byte_for_byte(split):
    ours = tds.YoloSegDataset(split, imgsz=SIZE, channels=4)
    theirs = jds.YoloSegDataset(split, imgsz=SIZE, channels=4)
    shapes = [ours.orig_shape(i) for i in range(N)]
    assert sorted(set(shapes)) == [(48, 64), (64, 40), (64, 64)]
    assert tds.rect_groups(shapes, 3) == jds.rect_groups(shapes, 3)
    for group in tds.rect_groups(shapes, 3):
        hw = tds.rect_batch_shape([shapes[i] for i in group], SIZE)
        assert hw == jds.rect_batch_shape([shapes[i] for i in group], SIZE)
        items = [ours.item_rect(i, hw) for i in group]
        for i, it in zip(group, items):
            _equal(it, theirs.item_rect(i, hw))
        _equal(tds.collate_padded(items, 4), jds.collate_padded(items, 4))
    for ratio in (4, 8):
        items = [ours.item(i) for i in range(N)]
        _equal(tds.collate_padded(items, 16, ratio),
               jds.collate_padded(items, 16, ratio))
    kw = dict(max_inst=4, shuffle=True, seed=3, drop_last=False)
    got, want = list(tds.batches(ours, 3, **kw)), list(jds.batches(theirs, 3,
                                                                   **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal(a, b)


@pytest.fixture(scope="module")
def models():
    jmod = jbuild_yolo("yolov12", "n", nc=1, ch=4, task="segment")
    v = draw_variables(jmod, seed=5)
    sd = state_dict_from_jax(v)
    tmod = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu")
    return jmod, v, tmod, sd


def _recorded(monkeypatch):
    """Record the detections of each batch on both sides: the JAX
    validator's one `jax.device_get` a batch, the port's `detect_batch`."""
    got = {"jax": [], "port": []}
    device_get, detect = jax.device_get, validator.detect_batch

    def jax_get(x):
        out = device_get(x)
        got["jax"].append(out)
        return out

    def port_detect(*a, **kw):
        out = detect(*a, **kw)
        got["port"].append(out)
        return out

    monkeypatch.setattr(jvalidator.jax, "device_get", jax_get)
    monkeypatch.setattr(validator, "detect_batch", port_detect)
    return got


@pytest.mark.parametrize("rect,batch", [(False, 3), (True, N)])
def test_validate_detector_matches_jax(split, models, monkeypatch, rect,
                                       batch):
    jmod, v, tmod, sd = models
    got = _recorded(monkeypatch)
    kw = dict(imgsz=SIZE, batch_size=batch, rect=rect)
    want = jvalidator.validate_detector(jmod, v, split, **kw)
    ours = validator.validate_detector(tmod, sd, split, **kw)
    assert ours.keys() == want.keys()
    for k in want:
        assert abs(ours[k] - want[k]) <= 1e-6, (k, ours[k], want[k])
    assert len(got["port"]) == len(got["jax"]) == (1 if rect else 3)
    kept = 0
    for p, j in zip(got["port"], got["jax"]):
        np.testing.assert_array_equal(p[..., 6] > 0, j.valid)
        valid = j.valid
        kept += int(valid.sum())
        np.testing.assert_allclose(p[..., :4][valid], j.boxes[valid],
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(p[..., 4][valid], j.conf[valid],
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(p[..., 5][valid], j.cls[valid])
    assert kept > N


def test_validation_uses_the_weights_it_is_given(split, models,
                                                 monkeypatch):
    """Two weight sets in a row on one model: the second run's detections
    equal a fresh model's with those weights, and differ from the first's."""
    jmod, v, tmod, sd = models
    other = {k: (t * 0.9 if k.endswith(("conv.weight", ".bias")) else t)
             for k, t in sd.items()}
    got = _recorded(monkeypatch)
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    kw = dict(imgsz=SIZE, batch_size=N)
    validator.validate_detector(model, sd, split, **kw)
    second = validator.validate_detector(model, other, split, **kw)
    fresh = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    fresh.load_state_dict(other, strict=True)
    assert validator.validate_detector(fresh, None, split, **kw) == second
    first, again, ref = got["port"]
    np.testing.assert_array_equal(again, ref)
    assert not np.array_equal(first, again)


def test_validation_gives_the_model_its_mode_back(split, models):
    """A model in train mode comes back in train mode, with its BatchNorm
    statistics as they were; one in eval mode stays in eval mode."""
    _, _, _, sd = models
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    model.load_state_dict(sd, strict=True)
    stats = {k: v.clone() for k, v in model.state_dict().items()
             if "running_" in k}
    for training in (True, False):
        model.train(training)
        validator.validate_detector(model, None, split, imgsz=SIZE,
                                    batch_size=N)
        assert all(m.training == training for m in model.modules())
        now = model.state_dict()
        assert all(torch.equal(now[k], v) for k, v in stats.items())


class _LabelModel(torch.nn.Module):
    """Predictions made from labels: per image, each GT box shifted by a
    seeded 0-3 px (the score falls with the shift) plus two false boxes of
    low score; the rest of the (B, 84, 5) rows score 0."""

    def __init__(self, batch):
        super().__init__()
        self.spec = parse_model_spec("yolov12", "n", 1, 4, "detect")
        rng = np.random.default_rng(0)
        preds = np.zeros((len(batch["img"]), 84, 5), np.float32)
        for i in range(len(preds)):
            gt = batch["bboxes"][i][batch["valid"][i]] * SIZE
            shift = rng.uniform(-3, 3, gt.shape).astype(np.float32)
            preds[i, :len(gt), :4] = gt + shift
            preds[i, :len(gt), 4] = 0.9 - 0.1 * np.abs(shift).mean(1)
            preds[i, 30:32, :4] = [[16, 16, 8, 8], [48, 40, 10, 6]]
            preds[i, 30:32, 4] = [0.3, 0.2]
        self.preds = preds
        self.dummy = torch.nn.Parameter(torch.zeros(()))

    def forward(self, x):
        return types.SimpleNamespace(preds=torch.from_numpy(self.preds))

    def apply(self, variables, x, train=False):
        return types.SimpleNamespace(preds=jnp.asarray(self.preds))


def test_label_model_scores_high_on_both_sides(split):
    ds = tds.YoloSegDataset(split, imgsz=SIZE, channels=4)
    batch = tds.collate_padded([ds.item(i) for i in range(N)], 16)
    stand_in = _LabelModel(batch)
    kw = dict(imgsz=SIZE, batch_size=N)
    want = jvalidator.validate_detector(stand_in, {}, split, **kw)
    ours = validator.validate_detector(stand_in, None, split, **kw)
    assert want["map50"] > 0.5 and 0 < want["map"] < want["map50"]
    assert ours == want
