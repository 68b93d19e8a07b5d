"""PyTorch port: import isolation and device dispatch.

The port must run where JAX is absent (the GPU machine has none), so it may
import neither `jax`, `flax`, `optax` nor `yolou_tpu`; the trainer must import
without `cv2`, which that machine lacks too. Its CUDA wrappers must import
without nvcc or triton, run their plain versions on CPU tensors without
counting a launch, and `chip_smoke.py` must fail without a GPU.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels import build
from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused
from yolou_tpu_torch.kernels.attention import (area_attention,
                                               area_attention_fused,
                                               area_attention_qkv_fused)
from yolou_tpu_torch.kernels.nms import suppress_greedy

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "yolou_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yolou_tpu")


def _run(code_or_args, cwd, timeout=120):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def test_every_submodule_imports_without_jax_flax_or_yolou_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import yolou_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'yolou_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "from yolou_tpu_torch.kernels import build\n"
        "assert build._lib is None, 'kernel library loaded at import'\n"
        "print(len(names), bad)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    n, _, bad = res.stdout.strip().partition(" ")
    assert int(n) >= 30 and bad == "[]", res.stdout


def test_training_modules_import_without_jax_or_cv2():
    """The training slice by name, and `cv2` stays out until an image is
    decoded: the trainer is driven over in-memory batches where it is
    absent."""
    mods = ["data.augment", "data.config", "data.yolo_dataset",
            "engine.trainer_detector", "losses.dice", "losses.tal",
            "losses.v8"]
    code = (
        "import importlib, sys\n"
        f"for n in {mods!r}: importlib.import_module('yolou_tpu_torch.' + n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('cv2',)!r})\n"
        "print(bad)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_evaluation_modules_import_without_jax_or_cv2():
    """The whole-block kernel's wrapper and the evaluation slice by name;
    `cv2` stays out until the dataset decodes a file, so the evaluator runs
    over in-memory batches where it is absent."""
    mods = ["kernels.a2c2f", "models.segpp", "metrics.seg",
            "data.decoder_dataset", "engine.evaluator"]
    code = (
        "import importlib, sys\n"
        f"for n in {mods!r}: importlib.import_module('yolou_tpu_torch.' + n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('cv2',)!r})\n"
        "print(bad)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_decoder_training_modules_import_without_jax_or_cv2():
    """The decoder training modules by name: the losses, the trainer, the
    generators, the Gaussian splat and the synthetic data generator; `cv2`
    stays out until a file is read or written, so objectmaps are generated
    and the decoder is trained from arrays in memory where it is absent."""
    mods = ["losses.dice", "engine.trainer_decoder", "engine.generate",
            "ops.gaussian", "data.synthetic", "engine.predictor"]
    code = (
        "import importlib, sys\n"
        f"for n in {mods!r}: importlib.import_module('yolou_tpu_torch.' + n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('cv2', 'matplotlib', 'pandas')!r})\n"
        "print(bad)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_sources_name_no_jax_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|yolou_tpu)\b",
                     re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu*")) == [
        "a2c2f.cu", "attention_mma.cuh", "band_attention.cu",
        "band_attention.cuh", "greedy_nms.cu"]


def test_cpu_tensors_take_the_plain_versions_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 9, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 192)).astype(np.float32))
    b = torch.zeros(192)
    o, v = area_attention_qkv_fused(x, w, b, 2)
    assert o.device.type == "cpu" and o.shape == v.shape == x.shape
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, 11, 11], [20, 20, 30, 30]]],
                         dtype=torch.float32)
    keep = suppress_greedy(boxes, torch.ones(1, 3, dtype=torch.bool), 0.45)
    assert keep.tolist() == [[True, False, True]]
    q = x.clone().requires_grad_()
    area_attention_fused(q, x, x, 2).sum().backward()
    assert area_attention(x[..., :32].contiguous(), x[..., 32:].contiguous(),
                          x[..., :32].contiguous()).shape == (2, 9, 32)
    ws = [torch.from_numpy(rng.normal(0, 0.1, sh).astype(np.float32))
          for sh in [(8, 32), (32,)] + [(32, 96), (96,), (7, 7, 32), (32,),
                                        (32, 32), (32,), (32, 64), (64,),
                                        (64, 32), (32,)] * 2 + [(64, 16), (16,)]]
    y = a2c2f_fused(torch.zeros(1, 4, 4, 8), ws, 1, 1, 1)
    assert y.device.type == "cpu" and y.shape == (1, 4, 4, 16)
    assert kernels.launch_counts() == {
        "band_attention": 0, "greedy_nms": 0, "band_attention_train": 0,
        "band_attention_single": 0, "a2c2f": 0}
    assert kernels.backward_counts() == {"band_attention": 0,
                                         "band_attention_train": 1,
                                         "band_attention_single": 0}
    assert build._lib is None


def test_kernel_build_is_keyed_by_sources():
    path = build.library_path()
    assert path.parent == PKG / "_build"
    assert re.fullmatch(r"libyolou_kernels_[0-9a-f]{16}\.so", path.name)
    assert path == build.library_path()


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    res = _run([sys.executable, "chip_smoke.py"], REPO, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    # alone in a directory, without the package beside it
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run([sys.executable, "chip_smoke.py"], tmp_path, timeout=300)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert os.listdir(tmp_path) == ["chip_smoke.py"]
