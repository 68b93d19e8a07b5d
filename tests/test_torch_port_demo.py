"""PyTorch port: `tools/run_demo.py`, the four-stage demo, on the CPU at
64^2 over 8 / 4 / 4 synthetic images with one epoch per stage (batch 4):
each stage's files and outcomes, and `objectmap_auc` against the inline
Python of `tools/run_demo.sh` run with cv2 on the same files."""

import math
import os
import re
import sys

import numpy as np
import pytest

from yolou_tpu_torch.tools import run_demo

from .torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("demo"))
    out = run_demo.run_demo(root, "cpu", detector_epochs=1, decoder_epochs=1,
                            close_mosaic=0, val_every=1, imgsz=64,
                            images=(8, 4, 4), batch=4, objectmap_batch=8)
    return root, out


def test_the_four_stages_ran(demo):
    root, out = demo
    assert os.path.exists(os.path.join(root, "yolo_best.ckpt"))
    assert os.path.exists(os.path.join(root, "runs_dec", "segpp_final.ckpt"))
    for split, n in (("train", 8), ("val", 4), ("test", 4)):
        maps = sorted(os.listdir(os.path.join(root, "objectmap", split)))
        assert len(maps) == n and all(m.endswith("_20.npy") for m in maps)
    assert [v["epoch"] for v in out["validations"]] == [1]
    assert all(math.isfinite(v[k]) for v in out["validations"]
               for k in ("map50", "map"))
    assert out["decoder_epochs_run"] == out["best_val_dice_epoch"] == 1
    assert out["test"]["n_images"] == 4
    for k in ("dice", "precision", "recall"):
        assert math.isfinite(out["test"][k]), k
    assert set(out["stage_seconds"]) == set(out["launches"]) == {
        "train-detector", "generate-objectmaps", "train-decoder", "evaluate"}
    # on the CPU the wrappers run their plain versions: no launch counted
    assert all(not any(c.values()) for c in out["launches"].values())
    with open(os.path.join(root, "logs", "evaluate.log")) as f:
        assert '"dice"' in f.read()


def _inline_auc_source():
    with open(os.path.join(ROOT, "tools", "run_demo.sh")) as f:
        text = f.read()
    blocks = re.findall(r"<<'EOF'\n(.*?)\nEOF", text, re.S)
    return next(b for b in blocks if "aucs" in b)


def test_objectmap_auc_is_the_shell_script_s(demo, monkeypatch, capsys):
    root, out = demo
    ns = {}
    monkeypatch.setattr(sys, "argv", ["-", root])
    exec(compile(_inline_auc_source(), "run_demo.sh", "exec"), ns)
    assert ns["aucs"], "no map with both classes"
    want = {"auc": np.mean(ns["aucs"]), "fg_logit": np.mean(ns["fg_means"]),
            "bg_logit": np.mean(ns["bg_means"]), "n_maps": len(ns["aucs"])}
    got = run_demo.objectmap_auc(root)
    assert got == pytest.approx(want, rel=1e-12, abs=0)
    assert out["objectmap"] == got
    assert capsys.readouterr().out.startswith("objectmap AUC mean=")


def test_objectmap_auc_rounds_as_cv2_does(tmp_path):
    """Blocks whose mean sits at 127.5 and just below, against
    cv2.resize(INTER_AREA) of the same mask."""
    import cv2
    from yolou_tpu_torch.native.image import imwrite
    m = np.zeros((16, 16), np.uint8)
    m[:8, :8] = 255
    m[:8, 8:] = np.where(np.arange(64).reshape(8, 8) < 32, 255, 0)   # 127.5
    m[8:, :8] = np.where(np.arange(64).reshape(8, 8) < 31, 255, 7)   # 127.1
    m[8:, 8:] = 127
    os.makedirs(tmp_path / "masks" / "val")
    os.makedirs(tmp_path / "objectmap" / "val")
    imwrite(str(tmp_path / "masks" / "val" / "val_0000.png"), m)
    np.save(tmp_path / "objectmap" / "val" / "val_0000_20.npy",
            np.array([[0.9, 0.8], [0.1, 0.2]], np.float32))
    gt = cv2.resize(m, (2, 2), interpolation=cv2.INTER_AREA).ravel() > 127
    assert gt.tolist() == [True, True, False, False]
    got = run_demo.objectmap_auc(str(tmp_path))
    assert got["auc"] == 1.0 and got["n_maps"] == 1
