"""PyTorch port: the `convert` command against the JAX package's, on the
CPU.

From the same ultralytics-named `.pt` (written by the JAX command's
`--reverse` from a JAX-written `.ckpt`), the port's `.ckpt` must equal the
JAX command's byte for byte, for a detector and, with `--task detect`, a
YOLO-Seg++ file; its report the same. With the JAX command's default
`--task segment`, a YOLO-Seg++ file's meta records `segment`, a task the
variables (a detect graph) do not have: the port records the model's own
task, `detect`, and the variables are bit-identical. `--reverse` must give
the JAX command's `.pt`: the same keys and equal tensors (each
`num_batches_tracked` 0-d, as torch holds it, where the JAX exporter writes
shape (1,))."""

import json

import jax
import numpy as np
import pytest
import torch

from yolou_tpu.cli import convert as jax_convert
from yolou_tpu.utils.checkpoint import load_checkpoint
from yolou_tpu_torch import __main__ as port_main

from .test_torch_port_cli import CPU, data, det_ckpt  # noqa: F401
from .test_torch_port_cli import segpp_ckpt  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401


def _pt_pair(ckpt, tmp_path, name):
    """The `.pt` of `ckpt` by each side's `--reverse`."""
    paths = {s: str(tmp_path / f"{name}_{s}.pt") for s in ("jax", "port")}
    want = jax_convert.main(["--reverse", "--out", ckpt, "--pt",
                             paths["jax"]])
    got = port_main.main(["convert", "--reverse", "--out", ckpt, "--pt",
                          paths["port"], *CPU])
    assert got == want
    return paths


@pytest.mark.parametrize("kind", ["yolo", "segpp"])
def test_convert_reverse_matches_jax(det_ckpt, segpp_ckpt, tmp_path, kind):
    paths = _pt_pair(det_ckpt if kind == "yolo" else segpp_ckpt, tmp_path,
                     kind)
    a, b = (torch.load(paths[s], weights_only=True) for s in ("jax", "port"))
    assert sorted(b) == sorted(a) and len(a) > 500
    for k in a:
        w = a[k]
        if k.endswith(".num_batches_tracked"):
            # the JAX exporter writes shape (1,), torch's BatchNorm holds a
            # 0-d counter (both load into it); the value is 0 on both
            assert w.shape == (1,) and b[k].shape == ()
            w = w.reshape(())
        assert w.dtype == b[k].dtype and torch.equal(w, b[k]), k
    if kind == "segpp":
        assert any(k.startswith("encoder.") for k in a)


@pytest.mark.parametrize("kind,task", [("yolo", "segment"),
                                       ("segpp", "detect"),
                                       ("segpp", "segment")])
def test_convert_matches_jax(det_ckpt, segpp_ckpt, tmp_path, kind, task):
    pt = _pt_pair(det_ckpt if kind == "yolo" else segpp_ckpt, tmp_path,
                  kind)["jax"]
    outs = {s: str(tmp_path / f"{s}.ckpt") for s in ("jax", "port")}
    args = ["--pt", pt, "--kind", kind, "--task", task, "--imgsz", "32"]
    want = jax_convert.main(args + ["--out", outs["jax"]])
    got = port_main.main(["convert", *args, *CPU, "--out", outs["port"]])
    assert got == want and want["matched"] > 500
    blobs = [load_checkpoint(outs[s]) for s in ("jax", "port")]
    flat = [jax.tree_util.tree_leaves_with_path(b["variables"])
            for b in blobs]
    assert [p for p, _ in flat[1]] == [p for p, _ in flat[0]]
    for (_, w), (_, g) in zip(*flat):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    metas = [json.loads(b["meta_json"]) for b in blobs]
    if kind == "segpp" and task == "segment":
        # the JAX command records --task; the port the model's own task
        assert metas[0]["task"] == "segment" and metas[1]["task"] == "detect"
        assert ({**metas[0], "task": "detect"} == metas[1])
    else:
        with open(outs["jax"], "rb") as a, open(outs["port"], "rb") as b:
            assert a.read() == b.read()


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where there is no card")
@pytest.mark.parametrize("way", [["--reverse"], []])
def test_convert_runs_on_the_card_unless_asked_for_the_cpu(det_ckpt,
                                                          tmp_path, way):
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_main.main(["convert", *way, "--out", det_ckpt, "--pt",
                        str(tmp_path / "x.pt")])
