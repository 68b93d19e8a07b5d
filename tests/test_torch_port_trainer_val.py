"""PyTorch port: the detector trainer's validation during training, on the
CPU: yolov12n-seg (4 ch, nc=1) at 64^2, batch 2, over a synthetic directory
(4 train and 4 val images).

`train()` with `val_every=1` records mAP50 and mAP50-95 per epoch and
writes `best.ckpt` and `last.ckpt`; a validation leaves the training model's
mode, parameters and BatchNorm statistics bit-identical. The fitness rule is
held against the JAX trainer's (`yolou_tpu/engine/trainer_detector.py`:
fitness 0.1 mAP50 + 0.9 mAP50-95, `best` on a strict rise from -inf) by a
scripted validator, with the step stubbed out; no JAX step is compiled.
"""

import os

import numpy as np
import pytest
import torch

from yolou_tpu_torch.data import synthetic
from yolou_tpu_torch.data.augment import AugHyp
from yolou_tpu_torch.data.config import load_data_yaml
from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                     DetectorTrainer)
from yolou_tpu_torch.models.yolo import build_yolo

from .torch_threads import one_torch_thread  # noqa: F401

IMGSZ = 64


@pytest.fixture(scope="module")
def data_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("det_val"))
    synthetic.generate(root, {"train": 4, "val": 4}, size=IMGSZ, seed=13)
    return load_data_yaml(os.path.join(root, "data.yaml"))


def _trainer(data_cfg, run_dir, epochs, **kw):
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu", seed=2)
    cfg = DetectorTrainConfig(imgsz=IMGSZ, batch_size=2, epochs=epochs,
                              close_mosaic=1, max_instances=8,
                              warmup_epochs=1.0, val_every=1,
                              run_dir=str(run_dir), **kw)
    return DetectorTrainer(model, data_cfg, cfg, aug=AugHyp(scale=0.3),
                           device="cpu")


def _weights(run_dir):
    run = os.path.join(run_dir, os.listdir(run_dir)[0])
    return os.path.join(run, "weights")


def test_train_validates_the_ema_without_touching_the_model(data_cfg,
                                                            tmp_path):
    tr = _trainer(data_cfg, tmp_path / "a", epochs=2)
    real = tr.validate
    seen = []

    def validate(val_ds):
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        mode = [m.training for m in tr.model.modules()]
        out = real(val_ds)
        after = tr.model.state_dict()
        seen.append(out)
        assert [m.training for m in tr.model.modules()] == mode
        assert all(torch.equal(before[k], after[k]) for k in before)
        # the copy validated carries the EMA weights, not the model's
        ema = tr.ema_variables()
        vsd = tr._val_model.state_dict()
        assert all(torch.equal(vsd[k], ema[k]) for k in ema)
        assert not tr._val_model.training
        return out

    tr.validate = validate
    history = tr.train()
    assert tr.model.training and tr.step_count == 4
    assert len(seen) == 2 and tr.val_times and len(tr.val_times) == 2
    assert history["map50"] == [m["map50"] for m in seen]
    assert history["map"] == [m["map"] for m in seen]
    assert all(0.0 <= v <= 1.0 for v in history["map50"] + history["map"])
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()
    weights = _weights(tmp_path / "a")
    assert sorted(os.listdir(weights)) == ["best.ckpt", "last.ckpt"]

    # resume: one more epoch, one more validation, on the same clock
    tr2 = _trainer(data_cfg, tmp_path / "b", epochs=3)
    h2 = tr2.train(resume_from=os.path.join(weights, "last.ckpt"))
    assert tr2.step_count == 6 and len(h2["loss"]) == 1
    assert len(h2["map50"]) == len(h2["map"]) == 1
    assert sorted(os.listdir(_weights(tmp_path / "b"))) == ["best.ckpt",
                                                            "last.ckpt"]


def _jax_best_epochs(scripted):
    """The JAX trainer's rule (trainer_detector.py:517-525), literally."""
    best_fitness, out = float("-inf"), []
    for epoch, vm in enumerate(scripted):
        fitness = 0.1 * vm["map50"] + 0.9 * vm["map"]
        if fitness > best_fitness:
            best_fitness = fitness
            out.append(epoch)
    return out


def test_best_pt_follows_the_jax_fitness_rule(data_cfg, tmp_path,
                                              monkeypatch):
    """Scripted metrics with rises, a fall, a tie, a rise by fitness with
    a lower mAP50, and a higher mAP50 at a lower fitness: `best.ckpt` is
    written at exactly the epochs the JAX rule writes it."""
    scripted = [{"map50": 0.2, "map": 0.1}, {"map50": 0.5, "map": 0.2},
                {"map50": 0.1, "map": 0.05}, {"map50": 0.5, "map": 0.2},
                {"map50": 0.3, "map": 0.25}, {"map50": 0.9, "map": 0.16}]
    tr = _trainer(data_cfg, tmp_path / "c", epochs=len(scripted))
    calls = iter(scripted)
    tr.validate = lambda val_ds: dict(next(calls), precision=0.0, recall=0.0)
    zero = torch.zeros(())
    tr.step = lambda *a, **k: (zero, dict.fromkeys(("box", "cls", "dfl",
                                                    "seg"), zero))
    writes = []
    real_save = tr.save_checkpoint

    def save(path):
        writes.append((len(tr.history["loss"]), os.path.basename(path)))
        real_save(path)

    monkeypatch.setattr(tr, "save_checkpoint", save)
    history = tr.train()
    best = [epoch - 1 for epoch, name in writes if name == "best.ckpt"]
    assert best == _jax_best_epochs(scripted) == [0, 1, 4]
    assert [n for _, n in writes].count("last.ckpt") == len(scripted)
    assert history["map"] == [m["map"] for m in scripted]
