"""PyTorch port: the command line (`python -m yolou_tpu_torch`) against the
JAX package's, f32 on the CPU (`--device cpu`).

One synthetic directory at 64^2 and one JAX-written `.ckpt` of each kind
(a yolov12n-seg detector, a YOLO-Seg++ model) per module, their weights
drawn with numpy as the other port tests draw them. The dispatcher: help,
an unknown command, the command list. `val` (square and rect) must give
the JAX command's metrics within 1e-6 (`test_torch_port_validator.py`'s
tolerance); `evaluate` its Dice, precision and recall within 2e-3 and HD95
within 0.25 px (`test_torch_port_evaluator.py`'s, for masks thresholded at
0.5). `predict`, the generators and the module entry are in
`test_torch_port_cli_files.py`; `convert` and the trainers in
`test_torch_port_cli_train.py`.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.__main__ import COMMANDS as JAX_COMMANDS
from yolou_tpu.cli import evaluate as jax_evaluate
from yolou_tpu.cli import val as jax_val
from yolou_tpu.data import synthetic
from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu.utils.model_io import save_model as jax_save_model
from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch.data.decoder_dataset import DecoderDataset
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_port_segpp import _draw
from .test_torch_port_slice import IMGSZ
from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_data"))
    yaml = synthetic.generate(root, {"train": 4, "val": 4, "test": 6},
                              size=IMGSZ, seed=6)
    return root, yaml


@pytest.fixture(scope="module")
def det_ckpt(tmp_path_factory):
    """A JAX-written yolov12n-seg detector file (4 ch, nc=1)."""
    from yolou_tpu.models.yolo import build_yolo as jbuild
    path = str(tmp_path_factory.mktemp("cli_det") / "det.ckpt")
    v = draw_variables(jbuild("yolov12", "n", nc=1, ch=4, task="segment"))
    jax_save_model(path, v, nc=1, ch=4, task="segment")
    return path


@pytest.fixture(scope="module")
def segpp_ckpt(tmp_path_factory, data):
    """A JAX-written YOLO-Seg++ file, its decoder's output bias centred on
    the test split's first batch (random weights give mask logits of one
    sign otherwise), as `test_torch_port_evaluator.py` does."""
    root, _ = data
    jmod = jsegpp.YOLOSegPP(spec=jax_spec("yolov12", "n", 1, 4, "detect"))
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, IMGSZ, IMGSZ, 4)), train=False))
    v = _draw(shapes, seed=11)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.5 if p[-1].key == "var" else a, v["batch_stats"])
    tmod = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    ds = DecoderDataset(root, "images/test", "masks/test", IMGSZ)
    with torch.no_grad():
        x = torch.from_numpy(next(ds.batches(4))[0]).permute(0, 3, 1, 2)
        median = float(tmod(x)[0].median())
    bias = v["params"]["decoder"]["output"]["bias"]
    v["params"]["decoder"]["output"]["bias"] = bias - np.float32(median)
    path = str(tmp_path_factory.mktemp("cli_segpp") / "segpp.ckpt")
    jax_save_model(path, v, nc=1, ch=4, task="detect", kind="segpp")
    return path


def test_help_lists_the_ported_commands(capsys):
    assert port_main.main(["--help"]) == 0
    listed = capsys.readouterr().out.split("commands:")[1].split()
    assert listed == list(port_main.COMMANDS)
    assert listed == list(JAX_COMMANDS)
    assert port_main.main([]) == 0


def test_unknown_command_exits_2(capsys):
    assert port_main.main(["frobnicate"]) == 2
    assert "unknown command 'frobnicate'" in capsys.readouterr().out


@pytest.mark.parametrize("cmd", ["train-detector", "train-decoder"])
def test_data_parallel_refuses_by_name(cmd):
    """`--data-parallel N` on CUDA with fewer than N cards raises by name
    before anything runs, as the JAX package's `make_mesh` fails with too
    few devices (the CPU ranks are in `test_torch_port_parallel_cli.py`)."""
    n = max(2, torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError,
                       match=f"--data-parallel {n}: one CUDA device a rank"):
        port_main.main([cmd, "--data-parallel", str(n), "--device", "cuda"])


def _close(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


@pytest.mark.parametrize("rect", [False, True])
def test_val_matches_jax(data, det_ckpt, rect):
    _, yaml = data
    args = ["--data", yaml, "--model", det_ckpt, "--imgsz", str(IMGSZ),
            "--batch", "3"] + (["--rect"] if rect else [])
    want = jax_val.main(args)
    got = port_main.main(["val", *args, *CPU])
    _close(got, want, 1e-6)


@pytest.mark.parametrize("hd95", [True, False])
def test_evaluate_matches_jax(data, segpp_ckpt, hd95):
    root, _ = data
    args = ["--model", segpp_ckpt, "--data", root, "--imgsz", str(IMGSZ),
            "--batch", "4"] + ([] if hd95 else ["--no-hd95"])
    want = jax_evaluate.main(args)
    got = port_main.main(["evaluate", *args, *CPU])
    assert got.keys() == want.keys()
    assert got["n_images"] == want["n_images"] == 6
    for k in ("dice", "precision", "recall"):
        assert abs(got[k] - want[k]) <= 2e-3, (k, got[k], want[k])
    if hd95:
        assert abs(got["hd95"] - want["hd95"]) <= 0.25, (got, want)
    else:
        assert np.isnan(got["hd95"]) and np.isnan(want["hd95"])
