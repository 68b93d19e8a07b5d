"""PyTorch port: `train-detector` and `train-decoder` with `--data-parallel
2 --device cpu` (two gloo rank processes) against `--data-parallel 1` (the
mesh path in one rank), one epoch at 64^2 over the synthetic directory of
`test_torch_port_cli.py`.

Rank 0 alone writes: one run directory with `config.json` and the
checkpoints, the `--out` / `segpp_final.ckpt` model file, one epoch line
printed. The histories agree: the losses within 1e-3 relative (a step over
two ranks equals one process's up to the order of f32 sums, through two
updates), the validation metrics within 1e-3.
"""

import os

import numpy as np
import pytest

from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch.cli import common

from .test_torch_port_cli import CPU, data, det_ckpt  # noqa: F401
from .test_torch_port_slice import IMGSZ
from .torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def launch_timeout(monkeypatch):
    monkeypatch.setattr(common, "LAUNCH_TIMEOUT", 240)


def _close(got, want, keys, rtol, atol):
    for k in keys:
        assert len(got[k]) == len(want[k]) == 1, k
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)


def _run_files(run_dir):
    runs = os.listdir(run_dir)
    assert len(runs) == 1
    return sorted(os.listdir(os.path.join(run_dir, runs[0]))), sorted(
        os.listdir(os.path.join(run_dir, runs[0], "weights")))


def test_train_detector_data_parallel(data, det_ckpt, tmp_path, capfd):
    _, yaml = data
    hist = {}
    for n in (1, 2):
        hist[n] = port_main.main([
            "train-detector", "--data", yaml, "--model", det_ckpt,
            "--imgsz", str(IMGSZ), "--batch", "2", "--epochs", "1",
            "--close-mosaic", "0", "--val-every", "1",
            "--run-dir", str(tmp_path / f"rd{n}"),
            "--out", str(tmp_path / f"out{n}.ckpt"),
            "--data-parallel", str(n), *CPU])
        assert _run_files(tmp_path / f"rd{n}") == (
            ["config.json", "weights"], ["best.ckpt", "last.ckpt"])
        assert os.path.exists(tmp_path / f"out{n}.ckpt")
    out = capfd.readouterr().out
    assert out.count("epoch 1/1") == 2 and out.count("saved EMA") == 2
    _close(hist[2], hist[1], ("loss", "box", "cls", "dfl", "seg"), 1e-3, 0)
    _close(hist[2], hist[1], ("map50", "map", "lr"), 0, 1e-3)
    assert hist[1]["seg"][0] > 0


def test_train_decoder_data_parallel(data, det_ckpt, tmp_path, capfd):
    root, _ = data
    assert port_main.main(["generate-objectmaps", "--data_dir", root,
                           "--yolo_dir", det_ckpt, "--image_size",
                           str(IMGSZ), *CPU])["train"] == 4
    hist = {}
    for n in (1, 2):
        run_dir = tmp_path / f"runs{n}"
        hist[n] = port_main.main([
            "train-decoder", "--model", det_ckpt, "--data", root,
            "--imgsz", str(IMGSZ), "--batch", "4", "--epochs", "1",
            "--run-dir", str(run_dir), "--data-parallel", str(n), *CPU])
        stamp, final = sorted(os.listdir(run_dir))
        assert final == "segpp_final.ckpt"
        files = set(os.listdir(run_dir / stamp))
        assert {"config.json", "history.csv", "weights"} <= files
        assert sorted(os.listdir(run_dir / stamp / "weights")) == [
            "best.ckpt", "last.ckpt"]
    assert capfd.readouterr().out.count("epoch 1/1") == 2
    _close(hist[2], hist[1], ("train_loss", "train_dice_metric"), 1e-5, 1e-6)
    _close(hist[2], hist[1], ("val_loss", "val_dice_metric",
                              "val_precision", "val_recall"), 1e-5, 1e-6)
    np.testing.assert_allclose(hist[2]["val_hd95_metric"],
                               hist[1]["val_hd95_metric"], rtol=1e-5,
                               atol=1e-6)
