"""PyTorch port: the file-writing commands against the JAX package's, f32 on
the CPU (`--device cpu`), and the module entry point.

The same synthetic directory and JAX-written detector `.ckpt` as
`test_torch_port_cli.py`. `predict` must give the JAX command's summary:
the same paths, detection counts and printed lines, scores within 1e-4, the
same `detections.json` and file names under `--save-dir`.
`generate-objectmaps` and `generate-heatmaps` must write the JAX commands'
files: objectmaps within 1e-4 (`test_torch_port_generate.py`'s tolerance:
logits of order 1 through 22 layers), heatmap PNGs within one level on
under 1 % of the pixels (x255 truncated to uint8). `python -m
yolou_tpu_torch` runs as a module: help 0, an unknown command 2.
"""

import json
import os
import subprocess
import sys

import cv2
import numpy as np

from yolou_tpu.cli import generate_heatmaps as jax_heatmaps
from yolou_tpu.cli import generate_objectmaps as jax_objectmaps
from yolou_tpu.cli import predict as jax_predict
from yolou_tpu_torch import __main__ as port_main

from .test_torch_port_cli import CPU, data, det_ckpt  # noqa: F401
from .test_torch_port_slice import IMGSZ
from .torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
def _run(*args):
    cmd = [sys.executable, "-m", "yolou_tpu_torch"]
    return subprocess.run([*cmd, *args], cwd=REPO, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


def test_module_entry_exit_codes():
    """`python -m yolou_tpu_torch`: help 0, unknown 2, a command's flag
    error 2 (argparse), a card asked for where there is none non-zero."""
    run = _run
    res = run("--help")
    assert res.returncode == 0 and "generate-objectmaps" in res.stdout
    assert run("nope").returncode == 2
    assert run("val").returncode == 2                 # --data is required
    res = run("val", "--data", REPO)
    assert res.returncode != 0 and "--device cpu" in res.stderr


def test_predict_matches_jax(data, det_ckpt, tmp_path, capsys):
    root, _ = data
    src = os.path.join(root, "images", "val")
    args = ["--source", src, "--model", det_ckpt, "--imgsz", str(IMGSZ),
            "--batch", "3"]
    want = jax_predict.main(args + ["--save-dir", str(tmp_path / "jax")])
    want_out = capsys.readouterr().out
    got = port_main.main(["predict", *args, "--save-dir",
                          str(tmp_path / "port"), *CPU])
    got_out = capsys.readouterr().out
    assert [r.path for r in got] == [r.path for r in want]
    assert [len(r) for r in got] == [len(r) for r in want]
    assert sum(len(r) for r in got) > 0
    lines = lambda out, side: [
        ln.replace(str(tmp_path / side), "DIR") for ln in out.splitlines()
        if "detection(s)" in ln or ln.startswith("saved ")]
    assert lines(got_out, "port") == lines(want_out, "jax")
    summaries = [json.load(open(tmp_path / side / "detections.json"))
                 for side in ("port", "jax")]
    for g, w in zip(*summaries):
        assert (g["path"], g["detections"]) == (w["path"], w["detections"])
        np.testing.assert_allclose(g["conf"], w["conf"], atol=1e-4, rtol=0)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))


def test_generators_match_jax(data, det_ckpt, tmp_path):
    root, _ = data
    common = ["--data_dir", root, "--yolo_dir", det_ckpt, "--image_size",
              str(IMGSZ), "--batch_size", "3"]
    want, got = {}, {}
    for name, jax_cli in (("objectmaps", jax_objectmaps),
                          ("heatmaps", jax_heatmaps)):
        want[name] = jax_cli.main(common + ["--out_dir",
                                            str(tmp_path / "jax")])
        got[name] = port_main.main([f"generate-{name}", *common, "--out_dir",
                                    str(tmp_path / "port"), *CPU])
    assert got == want
    assert want["objectmaps"] == {"test": 6, "train": 4, "val": 4}
    differ = total = 0
    for split in ("test", "train", "val"):
        for kind in ("objectmap", "heatmap"):
            names = sorted(os.listdir(tmp_path / "jax" / kind / split))
            assert names == sorted(os.listdir(tmp_path / "port" / kind
                                              / split))
            for n in names:
                a, b = (str(tmp_path / side / kind / split / n)
                        for side in ("jax", "port"))
                if kind == "objectmap":
                    np.testing.assert_allclose(np.load(b), np.load(a),
                                               atol=1e-4, rtol=0)
                    continue
                w, g = (cv2.imread(f, cv2.IMREAD_UNCHANGED).astype(int)
                        for f in (a, b))
                assert g.shape == w.shape == (IMGSZ, IMGSZ)
                assert np.abs(g - w).max() <= 1
                differ += int((g != w).sum())
                total += g.size
    assert differ <= 0.01 * total


def test_predict_without_cv2_says_so_and_writes_the_json(data, det_ckpt,
                                                         tmp_path, capsys,
                                                         monkeypatch):
    """`--save-dir` where cv2 is absent: the note comes before the model
    runs, and `detections.json` alone is written; `--stem-s2d` changes
    nothing."""
    root, _ = data
    src = os.path.join(root, "images", "val")
    args = ["predict", "--source", src, "--model", det_ckpt, "--imgsz",
            str(IMGSZ), *CPU]
    plain = port_main.main(args)
    capsys.readouterr()
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = port_main.main(args + ["--stem-s2d", "--save-dir",
                                 str(tmp_path / "out")])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("cv2 is not installed")
    assert os.listdir(tmp_path / "out") == ["detections.json"]
    for g, w in zip(got, plain):
        assert g.path == w.path
        np.testing.assert_array_equal(g.boxes.data, w.boxes.data)
