"""PyTorch port: `convert --arch yolov8 | yolo11` against the JAX
package's command, on the CPU.

From one ultralytics-named `.pt` (the JAX command's `--reverse` of a
JAX-written yolov8n-seg or yolo11n-seg file, 4 channels, nc=1, weights
drawn with numpy as `test_torch_port_slice.py` draws them), the port's
`.ckpt` must equal the JAX command's byte for byte, with the same report;
the port's `--reverse` must give the JAX command's tensors. Each JAX
convert compiles its init template (~10 s a family here).
"""

import pytest
import torch

from yolou_tpu.cli import convert as jax_convert
from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.utils import model_io as jmodel_io
from yolou_tpu_torch import __main__ as port_main

from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

CPU = ["--device", "cpu"]
SIZE = 32
FAMILIES = ("yolov8", "yolo11")


@pytest.mark.parametrize("arch", FAMILIES)
def test_convert_arch_matches_jax(tmp_path, arch):
    """From one ultralytics-named `.pt` (the JAX command's `--reverse` of
    a JAX-written file), `convert --arch` writes the JAX command's `.ckpt`
    byte for byte with the same report; the port's `--reverse` gives the
    same tensors back."""
    v = draw_variables(build_yolo_jax(arch, "n", nc=1, ch=4,
                                      task="segment"), seed=len(arch))
    src = str(tmp_path / "src.ckpt")
    jmodel_io.save_model(src, v, arch=arch, nc=1, ch=4, task="segment")
    pts = {s: str(tmp_path / f"{s}.pt") for s in ("jax", "port")}
    jax_convert.main(["--reverse", "--out", src, "--pt", pts["jax"]])
    port_main.main(["convert", "--reverse", "--out", src, "--pt",
                    pts["port"], *CPU])
    a, b = (torch.load(pts[s], weights_only=True) for s in ("jax", "port"))
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k].reshape(b[k].shape), b[k]) for k in a)
    outs = {s: str(tmp_path / f"{s}.ckpt") for s in ("jax", "port")}
    args = ["--pt", pts["jax"], "--arch", arch, "--imgsz", str(SIZE)]
    want = jax_convert.main(args + ["--out", outs["jax"]])
    got = port_main.main(["convert", *args, *CPU, "--out", outs["port"]])
    assert got == want and want["matched"] > 300 and not want["missing"]
    with open(outs["jax"], "rb") as f, open(outs["port"], "rb") as g:
        assert f.read() == g.read()
