"""PyTorch port: `export` against the JAX package's, f32 on the CPU.

One JAX-written yolov12n-seg `.ckpt` (4 ch, nc=1, weights drawn with numpy
as `test_torch_port_slice.py` draws them) exported at 64^2, batch 2, by both
packages' `export` commands. The artifact's files: `weights.msgpack` byte
for byte the JAX file, `meta.json` equal but for `platforms`. The port's
`ExportedModel` against the JAX `ExportedModel` on seeded images: boxes
within 1e-3 (pixels at 64^2), scores, mask coefficients and protos within
1e-4 (the forward's f32 distance between the packages,
`test_torch_port_slice.py`), `valid` equal; against the port's live
`Predictor.infer` within 1e-6. The saved program's graph holds the kernel
operators, 8 of kernel A and 1 of kernel B, and takes a second seed's
weights by name. The TPU-only flags are refused by name. `--kind segpp`
and the kernels' operators are in `test_torch_port_export_ops.py`.
"""

import json
import os
import shutil
from collections import Counter

import numpy as np
import pytest
import torch

from yolou_tpu.cli import export as jax_export
from yolou_tpu.engine.exporter import ExportedModel as JaxExportedModel
from yolou_tpu.models.yolo import build_yolo as jbuild
from yolou_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from yolou_tpu.utils.model_io import save_model as jax_save_model
from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch import kernels
from yolou_tpu_torch.engine.exporter import ExportedModel
from yolou_tpu_torch.engine.predictor import Predictor
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.tools.convert import state_dict_from_jax
from yolou_tpu_torch.utils.model_io import load_model

from .test_torch_port_slice import IMGSZ
from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
BATCH = 2
KERNEL_OPS = {"yolou.band_attention_qkv.default": 8,
              "yolou.greedy_nms.default": 1}


@pytest.fixture(scope="module")
def det_variables():
    return draw_variables(jbuild("yolov12", "n", nc=1, ch=4,
                                 task="segment"))


@pytest.fixture(scope="module")
def det_ckpt(tmp_path_factory, det_variables):
    """A JAX-written yolov12n-seg detector file (4 ch, nc=1)."""
    path = str(tmp_path_factory.mktemp("export_det") / "det.ckpt")
    jax_save_model(path, det_variables, nc=1, ch=4, task="segment")
    return path


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory, det_ckpt):
    """The port's and the JAX package's artifact directories of the same
    file; the port's manifest as its command returned it."""
    root = tmp_path_factory.mktemp("exported")
    args = ["--model", det_ckpt, "--imgsz", str(IMGSZ), "--batch",
            str(BATCH)]
    port_dir, jax_dir = str(root / "port"), str(root / "jax")
    kernels.reset_launch_counts()
    meta = port_main.main(["export", *args, "--out", port_dir, *CPU])
    jax_export.main([*args, "--out", jax_dir, "--platforms", "cpu"])
    return port_dir, jax_dir, meta


@pytest.fixture(scope="module")
def program(artifacts):
    return ExportedModel(artifacts[0])


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(4).integers(0, 256, (BATCH, IMGSZ, IMGSZ, 4),
                                             dtype=np.uint8)


def _live(ckpt_or_model, imgs):
    """The port's live predictor on the same weights: the program's six
    outputs in the JAX order and layouts."""
    model = (load_model(ckpt_or_model, device="cpu")
             if isinstance(ckpt_or_model, str) else ckpt_or_model)
    dets, out = Predictor(model, imgsz=IMGSZ).infer(torch.from_numpy(imgs))
    return (dets.boxes, dets.conf, dets.cls, dets.valid, dets.extra,
            out.protos.permute(0, 2, 3, 1))


def _assert_matches(got, want, tols):
    assert len(got) == len(want) == len(tols)
    for g, w, tol in zip(got, want, tols):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        if w.dtype == bool:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)


def test_export_writes_the_jax_files(artifacts):
    port_dir, jax_dir, meta = artifacts
    assert sorted(os.listdir(port_dir)) == ["meta.json", "program.pt2",
                                            "weights.msgpack"]
    with open(os.path.join(port_dir, "weights.msgpack"), "rb") as f:
        port_weights = f.read()
    with open(os.path.join(jax_dir, "weights.msgpack"), "rb") as f:
        assert port_weights == f.read()
    metas = []
    for d in (port_dir, jax_dir):
        with open(os.path.join(d, "meta.json")) as f:
            metas.append(json.load(f))
    port, jax_meta = metas
    assert port == meta and port.pop("platforms") == ["cpu"]
    jax_meta.pop("platforms")
    assert port == jax_meta
    assert port["stem_s2d"] is False
    # tracing ran the kernels' fake versions only
    assert not any(kernels.launch_counts().values())


def test_exported_program_matches_the_jax_program(artifacts, program, imgs):
    want = JaxExportedModel(artifacts[1])(imgs)
    got = program(imgs)
    assert program.meta["outputs"] == ["boxes", "conf", "cls", "valid",
                                       "mask_coefs", "protos"]
    assert int(np.asarray(want[3]).sum()) > 0     # NMS has work
    _assert_matches(got, want, (1e-3, 1e-4, 0, None, 1e-4, 1e-4))


def test_exported_program_matches_the_live_predictor(det_ckpt, program,
                                                     imgs):
    kernels.reset_launch_counts()
    got = program(imgs)
    assert not any(kernels.launch_counts().values())   # CPU: plain versions
    with torch.no_grad():
        want = _live(det_ckpt, imgs)
    _assert_matches(got, want, (1e-6, 1e-6, 0, None, 1e-6, 1e-6))


def test_saved_program_carries_the_kernel_operators(program):
    ops = Counter(str(n.target) for n in program.program.graph.nodes
                  if n.op == "call_function"
                  and str(n.target).startswith("yolou."))
    assert dict(ops) == KERNEL_OPS


def test_a_second_seeds_weights_give_its_live_outputs(artifacts, program,
                                                      imgs, tmp_path):
    """One program, any checkpoint of the architecture: a second seed's
    JAX-written weights.msgpack in a copy of the directory."""
    swapped = str(tmp_path / "swapped")
    shutil.copytree(artifacts[0], swapped)
    v = draw_variables(jbuild("yolov12", "n", nc=1, ch=4, task="segment"),
                       seed=1)
    jax_save_checkpoint(os.path.join(swapped, "weights.msgpack"),
                        {"variables": v})
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    got = ExportedModel(swapped)(imgs)
    with torch.no_grad():
        want = _live(model, imgs)
    _assert_matches(got, want, (1e-6, 1e-6, 0, None, 1e-6, 1e-6))
    assert not torch.equal(got[5], program(imgs)[5])   # the weights differ


@pytest.mark.parametrize("flag,match", [
    (["--stem-s2d"], "--stem-s2d"), (["--platforms", "cpu,tpu"],
                                     "--platforms")])
def test_tpu_only_flags_are_refused_by_name(flag, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        port_main.main(["export", "--model", "absent.ckpt", "--out",
                        str(tmp_path / "x"), "--imgsz", "32", *flag, *CPU])
    assert not os.path.exists(tmp_path / "x")
