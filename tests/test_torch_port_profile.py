"""PyTorch port: `profile`, `utils/profiling.py`, `visualize-logits` and the
dispatcher's command list against the JAX package's, on the CPU.

`pava_nondecreasing` equal to the JAX tool's on seeded inputs;
`profile_prefixes` at 64^2, batch 1, 2 rounds, a few prefixes on the CPU
(host clock: no device number is made here): the JAX tool's keys, no
negative row, rows summing to `total_ms`; the `profile` command writes the
same table to `--out` and refuses `--no-pallas`. `StepTimer` on the same
clock readings and `summarize_params` (total and per-layer counts) against
the JAX package's on the same architecture. `visualize-logits` on one
JAX-written `.ckpt` and one PNG against the JAX command: `probs` within
1e-5 (the f32 distance of the two forwards at 64^2,
`test_torch_port_generate.py`), the printed statistics equal.
`ops/letterbox.py::resize_normalize` against JAX's within 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.__main__ import COMMANDS as JAX_COMMANDS
from yolou_tpu.cli import visualize_logits as jax_visualize
from yolou_tpu.models.yolo import build_yolo as jbuild
from yolou_tpu.ops.letterbox import resize_normalize as jax_resize_normalize
from yolou_tpu.tools import profile_layers as jax_profile_layers
from yolou_tpu.utils import profiling as jax_profiling
from yolou_tpu.utils.model_io import save_model as jax_save_model
from yolou_tpu_torch import __main__ as port_main
from yolou_tpu_torch import kernels
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.native.image import imwrite
from yolou_tpu_torch.ops.letterbox import resize_normalize
from yolou_tpu_torch.tools import profile_layers
from yolou_tpu_torch.utils import profiling

from .test_torch_port_slice import IMGSZ
from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
JAX_PROFILE_KEYS = {"batch", "imgsz", "dtype", "use_pallas", "rounds",
                    "total_ms", "total_half_spread_ms", "per_layer"}
ROW_KEYS = {"layers", "block", "ms", "half_spread_ms"}


def test_dispatcher_lists_the_jax_commands_in_order(capsys):
    assert list(port_main.COMMANDS) == list(JAX_COMMANDS)
    assert port_main.main(["--help"]) == 0
    listed = capsys.readouterr().out.split("commands:")[1].split()
    assert listed == list(JAX_COMMANDS)


@pytest.mark.parametrize("seed", range(4))
def test_pava_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ys = list(np.cumsum(rng.normal(0.5, 1.0, 3 + 7 * seed)))
    got = profile_layers.pava_nondecreasing(ys)
    assert got == jax_profile_layers.pava_nondecreasing(ys)
    assert all(b >= a for a, b in zip(got, got[1:]))


def _check_table(out, layers):
    assert JAX_PROFILE_KEYS <= set(out)
    assert out["device"] == "cpu" and out["timer"] == "host clock"
    assert out["card"] is None
    rows = out["per_layer"]
    assert len(rows) == len(layers)
    assert [r["layers"] for r in rows] == [
        f"{a}..{b - 1}" for a, b in zip([0] + layers[:-1], layers)]
    for r in rows:
        assert set(r) == ROW_KEYS and r["ms"] >= 0 and r["half_spread_ms"] >= 0
    np.testing.assert_allclose(sum(r["ms"] for r in rows), out["total_ms"],
                               rtol=1e-9)
    assert out["total_ms"] > 0


def test_profile_prefixes_on_the_cpu():
    kernels.reset_launch_counts()
    spec = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu").spec
    layers = [2, 7, len(spec.layers)]           # the last: the whole forward
    out = profile_layers.profile_prefixes(1, IMGSZ, dtype_name="float32",
                                          layers=layers, rounds=2,
                                          device="cpu", iters=2)
    _check_table(out, layers)
    assert out["rounds"] == 2 and out["batch"] == 1
    assert [r["block"] for r in out["per_layer"]] == [
        "+".join(spec.layers[j].block for j in range(a, b))
        for a, b in zip([0] + layers[:-1], layers)]
    assert out["per_layer"][-1]["block"].endswith("+HEAD")
    assert not any(kernels.launch_counts().values())    # plain versions


def test_profile_command_writes_the_table(tmp_path, capsys):
    out_path = str(tmp_path / "PROFILE.json")
    out = port_main.main(["profile", "--batch", "1", "--imgsz", "32",
                          "--layers", "3,11", "--out", out_path, *CPU])
    _check_table(out, [3, 11])
    assert out["rounds"] == 6 and out["dtype"] == "bfloat16"
    with open(out_path) as f:
        assert json.load(f) == out
    printed = capsys.readouterr().out.splitlines()
    assert json.loads(printed[-1]) == out
    assert sum(ln.startswith("layers ") for ln in printed) == 2


def test_profile_refuses_no_pallas_by_name(tmp_path):
    with pytest.raises(NotImplementedError, match="--no-pallas"):
        port_main.main(["profile", "--no-pallas", "--out",
                        str(tmp_path / "p.json"), *CPU])


def test_step_timer_matches_jax(monkeypatch):
    """Both timers over the same clock readings, window 3."""
    clock = iter([0.0, 0.5, 1.25, 1.5, 3.0, 3.1, 4.0])
    ticks = list(clock)
    timers = [profiling.StepTimer(window=3),
              jax_profiling.StepTimer(window=3)]
    for t in ticks:
        for mod, timer in ((profiling, timers[0]),
                           (jax_profiling, timers[1])):
            monkeypatch.setattr(mod.time, "perf_counter", lambda t=t: t)
            timer.tick()
    assert timers[0].times == timers[1].times
    assert timers[0].step_time == timers[1].step_time
    assert timers[0].images_per_sec(8) == timers[1].images_per_sec(8)
    assert np.isnan(profiling.StepTimer().step_time)


def _rows(table):
    lines = table.splitlines()
    assert lines[0].split() == ["module", "params"]
    return [(ln.split()[0], int(ln.split()[1].replace(",", "")))
            for ln in lines[1:]]


@pytest.mark.parametrize("task", ["detect", "segment"])
def test_summarize_params_matches_jax(task):
    """Per layer (the JAX tree's depth 1 is the port's depth 2, below the
    `model` ModuleList) and in total; a deeper table sums to the same
    total."""
    jmod = jbuild("yolov12", "n", nc=1, ch=4, task=task)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, IMGSZ, IMGSZ, 4)), train=False))
    want = _rows(jax_profiling.summarize_params(shapes["params"], 1))
    model = build_yolo("yolov12", "n", nc=1, ch=4, task=task, device="cpu")
    got = _rows(profiling.summarize_params(model, 2))
    assert [n for _, n in got] == [n for _, n in want]
    assert [name for name, _ in got[:-1]] == [
        name.replace("model_", "model/") for name, _ in want[:-1]]
    deep = _rows(profiling.summarize_params(model, 4))
    assert sum(n for _, n in deep[:-1]) == deep[-1][1] == got[-1][1]


def test_trace_and_memory_stats_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "trace")):
        torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}


@pytest.fixture(scope="module")
def viz_inputs(tmp_path_factory):
    """A JAX-written yolov12n detector file and one seeded 4-channel PNG
    written by the port's codec."""
    root = tmp_path_factory.mktemp("viz")
    ckpt = str(root / "det.ckpt")
    v = draw_variables(jbuild("yolov12", "n", nc=1, ch=4, task="detect"))
    jax_save_model(ckpt, v, nc=1, ch=4, task="detect")
    png = str(root / "img.png")
    imwrite(png, np.random.default_rng(7).integers(
        0, 256, (48, 64, 4), dtype=np.uint8))
    return ckpt, png


def test_visualize_logits_matches_jax(viz_inputs, tmp_path, capsys):
    ckpt, png = viz_inputs
    args = [png, "--yolo_dir", ckpt, "--image_size", str(IMGSZ)]
    want = jax_visualize.main([*args, "--out", str(tmp_path / "jax.png")])
    jax_lines = capsys.readouterr().out.splitlines()
    kernels.reset_launch_counts()
    got = port_main.main(["visualize-logits", *args, "--out",
                          str(tmp_path / "port.png"), *CPU])
    port_lines = capsys.readouterr().out.splitlines()
    assert got.shape == want.shape == (IMGSZ // 8, IMGSZ // 8)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)
    assert port_lines[:2] == jax_lines[:2]
    assert port_lines[0].startswith("spatial_confidence(top20%)=")
    assert port_lines[2] == f"saved {tmp_path / 'port.png'}"
    assert os.path.getsize(tmp_path / "port.png") > 0
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("shape,size", [((2, 48, 64, 4), 32),
                                        ((1, 100, 60, 4), 64),
                                        ((1, 32, 32, 3), 32)])
def test_resize_normalize_matches_jax(shape, size):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    want = np.asarray(jax_resize_normalize(jnp.asarray(img), size))
    got = resize_normalize(torch.from_numpy(img), size)
    assert got.dtype == torch.float32
    assert got.shape == (shape[0], size, size, shape[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
