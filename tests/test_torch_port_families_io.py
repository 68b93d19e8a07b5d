"""PyTorch port: the yolov8 and yolo11 families across files and commands,
f32 on the CPU.

JAX variables of both families (weights drawn with numpy as
`test_torch_port_slice.py` draws them) cross to the port and back bit for
bit, for both tasks; `.ckpt` model files cross both ways between the
packages' `save_model` / `load_model` with the forwards within 1e-5 at 32^2;
and the files the port's `train-detector` and `export` write from a yolo11 model
name `yolo11`, which the JAX commands do not (they record the default
`yolov12`; ROADMAP Queue 3), and load back. `convert --arch` is in
`test_torch_port_families_convert.py`.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu.tools.torch2jax import jax_to_torch_state_dict
from yolou_tpu.utils import model_io as jmodel_io
from yolou_tpu.utils.checkpoint import load_checkpoint
from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch import kernels
from yolou_tpu_torch.cli.common import build_segpp_from_detector
from yolou_tpu_torch.data import synthetic
from yolou_tpu_torch.engine.exporter import ExportedModel
from yolou_tpu_torch.engine.predictor import Predictor
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.tools.convert import jax_variables, state_dict_from_jax
from yolou_tpu_torch.utils import model_io

from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
SIZE = 32
FAMILIES = ("yolov8", "yolo11")


@pytest.fixture(scope="module")
def drawn():
    """(arch, task) -> (JAX module, variables), nc=1, 4 channels."""
    out = {}
    for arch in FAMILIES:
        for task in ("segment", "detect"):
            jmod = build_yolo_jax(arch, "n", nc=1, ch=4, task=task)
            out[arch, task] = jmod, draw_variables(jmod, seed=len(arch))
    return out


def _same_tree(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert np.array_equal(g, w), path


@pytest.mark.parametrize("arch", FAMILIES)
@pytest.mark.parametrize("task", ["segment", "detect"])
def test_variables_round_trip_bit_exact(drawn, arch, task):
    """JAX -> port -> JAX: `state_dict_from_jax` equals the JAX package's
    exporter key for key and bit for bit (PSA's qkv unpermuted), loads
    strictly, and `jax_variables` of the loaded model gives the JAX tree
    back, path for path."""
    _, v = drawn[arch, task]
    sd = state_dict_from_jax(v)
    theirs = jax_to_torch_state_dict(v)
    assert sorted(sd) == sorted(theirs)
    for k, w in theirs.items():
        assert np.array_equal(sd[k].numpy(), w), k
    model = build_yolo(arch, "n", nc=1, ch=4, task=task, device="cpu")
    model.load_state_dict(sd, strict=True)
    _same_tree(jax_variables(model), v)


@pytest.fixture(scope="module", params=FAMILIES)
def crossing(request, drawn):
    """(arch, variables, the JAX forward's raw maps and protos on a seeded
    input, that input, the port's forward -> the same outputs)."""
    arch = request.param
    jmod, v = drawn[arch, "segment"]
    x = np.random.default_rng(2).random((2, SIZE, SIZE, 4), np.float32)
    apply = jax.jit(lambda v, a: jmod.apply(v, a, train=False))

    def pick(out):
        return [np.asarray(r) for r in out.raw] + [np.asarray(out.protos)]

    def forward(tmod):
        with torch.no_grad():
            out = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
        return [t.permute(0, 2, 3, 1).numpy()
                for t in list(out.raw) + [out.protos]]

    return arch, v, pick(apply(v, x)), forward


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_port_model_file_is_read_by_jax(crossing, tmp_path):
    arch, v, want, forward = crossing
    tmod = build_yolo(arch, "n", nc=1, ch=4, task="segment", device="cpu")
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    path = str(tmp_path / "m.ckpt")
    model_io.save_model(path, tmod)
    meta = json.loads(load_checkpoint(path)["meta_json"])
    assert (meta["arch"], meta["variant"]) == (arch, "n")
    jmod, jv = jmodel_io.load_model(path)
    assert jmod.spec == jax_spec(arch, "n", 1, 4, "segment")
    _same_tree(jv, v)
    _close(forward(tmod), want)


def test_jax_model_file_is_read_by_the_port(crossing, tmp_path):
    arch, v, want, forward = crossing
    path = str(tmp_path / "m.ckpt")
    jmodel_io.save_model(path, v, arch=arch, nc=1, ch=4, task="segment")
    tmod = model_io.load_model(path, device="cpu")
    assert not tmod.training
    assert (tmod.spec.arch, tmod.spec.legacy_head) == (arch,
                                                       arch == "yolov8")
    _close(forward(tmod), want)


@pytest.fixture(scope="module")
def yolo11_ckpt(tmp_path_factory, drawn):
    """A JAX-written yolo11n-seg detector file (4 ch, nc=1)."""
    path = str(tmp_path_factory.mktemp("fam_det") / "yolo11.ckpt")
    jmodel_io.save_model(path, drawn["yolo11", "segment"][1], arch="yolo11",
                         nc=1, ch=4, task="segment")
    return path


def test_train_detector_records_the_models_arch(yolo11_ckpt, tmp_path):
    """`train-detector --model yolo11.ckpt --epochs 1` at 64^2: the file it
    writes names `yolo11` (the JAX command writes `yolov12` there) and
    loads back into a yolo11 graph."""
    root = str(tmp_path / "data")
    yaml = synthetic.generate(root, {"train": 4, "val": 2}, size=64, seed=3)
    out = str(tmp_path / "det.ckpt")
    hist = port_main.main([
        "train-detector", "--data", yaml, "--model", yolo11_ckpt,
        "--imgsz", "64", "--batch", "2", "--epochs", "1", "--close-mosaic",
        "1", "--run-dir", str(tmp_path / "rd"), "--out", out, *CPU])
    assert len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all()
    meta = json.loads(load_checkpoint(out)["meta_json"])
    assert (meta["arch"], meta["variant"], meta["task"]) == (
        "yolo11", "n", "segment")
    model = model_io.load_model(out, device="cpu")
    assert model.spec == build_yolo("yolo11", "n", 1, 4, "segment",
                                    device="cpu").spec


def test_export_records_the_models_arch(yolo11_ckpt, tmp_path):
    """`export --model yolo11.ckpt` at 32^2, batch 2: meta.json names
    `yolo11`; the program carries one kernel B operator and no kernel A
    (no area attention), and its outputs equal the live predictor's."""
    out = str(tmp_path / "exported")
    kernels.reset_launch_counts()
    meta = port_main.main(["export", "--model", yolo11_ckpt, "--out", out,
                           "--imgsz", str(SIZE), "--batch", "2", *CPU])
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f) == meta
    assert (meta["arch"], meta["variant"]) == ("yolo11", "n")
    ex = ExportedModel(out)
    ops = [str(n.target) for n in ex.program.graph.nodes
           if str(n.target).startswith("yolou.")]
    assert ops == ["yolou.greedy_nms.default"]
    imgs = np.random.default_rng(4).integers(0, 256, (2, SIZE, SIZE, 4),
                                             dtype=np.uint8)
    got = ex(imgs)
    dets, out_ = Predictor(model_io.load_model(yolo11_ckpt, device="cpu"),
                           imgsz=SIZE).infer(torch.from_numpy(imgs))
    want = (dets.boxes, dets.conf, dets.cls, dets.valid, dets.extra,
            out_.protos.permute(0, 2, 3, 1))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-6, rtol=0)
    assert sum(kernels.launch_counts().values()) == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_segpp_from_a_family_detector(drawn, arch):
    """`train-decoder`'s and `evaluate`'s builder takes the detector's own
    family (the JAX package's takes yolov12 whatever the detector is): the
    YOLO graph holds the segment detector's weights but for the mask
    branches, and the decoder's skip widths follow the graph."""
    det = build_yolo(arch, "n", nc=1, ch=4, task="segment", device="cpu")
    det.load_state_dict(state_dict_from_jax(drawn[arch, "segment"][1]),
                        strict=True)
    model = build_segpp_from_detector(det, nc=1, ch=4, device="cpu")
    assert (model.spec.arch, model.spec.task) == (arch, "detect")
    got, want = model.yolo.state_dict(), det.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in got.items())
    assert model.decoder[0][0].cv1.conv.in_channels == 1 + {
        "yolov8": 64, "yolo11": 128}[arch]
