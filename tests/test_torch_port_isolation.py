"""PyTorch port: import isolation and device dispatch.

The port must run where JAX is absent (the GPU machine has none), so it may
import neither `jax`, `flax`, `optax` nor `yolou_tpu`; the trainer must import
without `cv2`, which that machine lacks too. Its CUDA wrappers must import
without nvcc or triton, run their plain versions on CPU tensors without
counting a launch, and raise on a CUDA tensor when the kernels cannot be
built, without running the plain version; `chip_smoke.py` must fail without
a GPU.
"""

import json
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
from yolou_tpu_torch.native import loader

from .torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "yolou_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yolou_tpu")


def _run(code_or_args, cwd, timeout=120):
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    # one torch thread: the tier-1 command runs six test workers at once
    return subprocess.run(args, cwd=cwd, capture_output=True, text=True,
                          timeout=timeout,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))


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


def test_mesh_and_predictor_import_without_their_optional_packages():
    """`parallel/mesh.py` and `engine/predictor.py` load no JAX module and
    none of `cv2`, PIL, `mss` or `pillow_heif` (each is imported in the
    call that reads a video, a stream, a camera, a screen, a PIL image or a
    HEIC file); the trainers, which import the mesh module, still import
    with `cv2` blocked."""
    optional = ("cv2", "PIL", "mss", "pillow_heif")
    code = (
        "import importlib, sys\n"
        "for n in ('parallel.mesh', 'engine.predictor'):\n"
        "    importlib.import_module('yolou_tpu_torch.' + n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + optional!r})\n"
        "print(bad)\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout
    code = (_BLOCK.format(blocked=FORBIDDEN + ("cv2",))
            + "import yolou_tpu_torch.engine.trainer_detector\n"
            "import yolou_tpu_torch.engine.trainer_decoder\n"
            "import yolou_tpu_torch.cli.train_detector\n"
            "import yolou_tpu_torch.cli.train_decoder\n"
            "print('ok')\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_sources_name_no_jax_module():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|yolou_tpu)\b",
                     re.M)
    offenders = [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
    assert sorted(p.name for p in (PKG / "csrc").glob("*.cu*")) == [
        "a2c2f.cuh", "a2c2f_bf16.cu", "a2c2f_f32.cu", "band_attention.cu",
        "band_attention.cuh", "band_attention_short.cu", "gemm_f32.cuh",
        "greedy_nms.cu", "hopper.cuh"]


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


def test_native_library_build_is_keyed_by_its_source(tmp_path,
                                                     monkeypatch):
    path = loader.library_path()
    assert path.parent == PKG / "_build"
    assert re.fullmatch(r"libyolou_io_[0-9a-f]{16}\.so", path.name)
    assert path == loader.library_path()
    edited = tmp_path / "yolou_io.cc"
    edited.write_text(loader.SOURCE.read_text() + "\n// edited\n")
    monkeypatch.setattr(loader, "SOURCE", edited)
    assert loader.library_path() != path


def test_native_build_failure_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    broken = tmp_path / "yolou_io.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SOURCE", broken)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path / "_build")
    try:
        loader.build()
    except RuntimeError as e:
        assert "g++ failed" in str(e) and "yolou_io.cc" in str(e), e
    else:
        raise AssertionError("a broken source built")


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


_BLOCK = (
    "import sys\n"
    "class _Block:\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        if name.split('.')[0] in {blocked!r}:\n"
    "            raise ImportError(f'blocked: {{name}}')\n"
    "sys.meta_path.insert(0, _Block())\n")


def test_detector_stage_modules_import_with_their_absent_packages_blocked():
    """The detector stage's modules (validator, detection metrics, model
    files and their msgpack codec, composite losses, segments) import with
    JAX, flax, optax, the JAX package, `msgpack` and `cv2` all blocked; no
    module of the package names `msgpack`."""
    blocked = FORBIDDEN + ("msgpack", "cv2")
    mods = ["engine.validator", "metrics.det", "utils.checkpoint",
            "utils.train_state",
            "utils.model_io", "utils.msgpack_lite", "losses.composite",
            "ops.segments", "engine.trainer_detector"]
    code = (_BLOCK.format(blocked=blocked)
            + "import importlib\n"
            f"for n in {mods!r}: importlib.import_module('yolou_tpu_torch.' + n)\n"
            "print('ok')\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
    pat = re.compile(r"^\s*(import|from)\s+msgpack\b", re.M)
    assert [p for p in PKG.rglob("*.py") if pat.search(p.read_text())] == []


def test_validator_and_model_files_work_in_memory_without_msgpack_or_cv2(
        tmp_path):
    """With `msgpack` and `cv2` blocked: `validate_detector` over a dataset
    object held in memory (square and rect), `save_model` / `load_model` of
    a small model with the same forward after the crossing, and
    `validate_detector` over a directory of PNGs written and read by the
    port's own codec (no cv2 needed since the port reads PNG itself)."""
    blocked = FORBIDDEN + ("msgpack", "cv2")
    code = _BLOCK.format(blocked=blocked) + f"""
import numpy as np, torch
from yolou_tpu_torch.engine.validator import validate_detector
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.utils.model_io import load_model, save_model

class Memory:
    def __init__(self):
        rng = np.random.default_rng(0)
        self.imgs = rng.integers(0, 255, (3, 32, 32, 4), dtype=np.uint8)
    def __len__(self):
        return 3
    def orig_shape(self, i):
        return (32, 32)
    def item(self, i):
        m = np.zeros((1, 32, 32), np.uint8)
        m[0, 8:20, 4:24] = 1
        return {{"img": self.imgs[i], "masks": m, "cls": np.zeros(1, np.int32)}}
    def item_rect(self, i, hw):
        it = self.item(i)
        assert hw == (64, 64), hw
        pad = lambda a: np.pad(a, [(0, 0)] * (a.ndim - 3) + [(0, 32), (0, 32)]
                               + [(0, 0)] * (a.ndim == 3))
        return dict(it, img=pad(it["img"]), masks=pad(it["masks"]))

model = build_yolo("yolov12", "n", 1, 4, "segment", device="cpu", seed=0)
for rect in (False, True):
    m = validate_detector(model, None, Memory(), imgsz=32, batch_size=2,
                          rect=rect)
    assert set(m) == {{"precision", "recall", "map50", "map"}}, m
path = {str(tmp_path / "m.ckpt")!r}
save_model(path, model)
back = load_model(path, device="cpu")
x = torch.rand(1, 4, 32, 32)
with torch.no_grad():
    assert torch.equal(model(x).preds, back(x).preds)
import os
from yolou_tpu_torch.native.image import imwrite
img_dir = os.path.join({str(tmp_path)!r}, "images", "val")
lbl_dir = os.path.join({str(tmp_path)!r}, "labels", "val")
os.makedirs(img_dir)
os.makedirs(lbl_dir)
for i, img in enumerate(Memory().imgs):
    imwrite(os.path.join(img_dir, f"{{i}}.png"), img)
    with open(os.path.join(lbl_dir, f"{{i}}.txt"), "w") as f:
        f.write("0 0.1 0.25 0.75 0.25 0.75 0.6 0.1 0.6\\n")
m = validate_detector(model, None, img_dir, imgsz=32, batch_size=2)
assert set(m) == {{"precision", "recall", "map50", "map"}}, m
print("ok")
"""
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_command_line_modules_import_with_jax_and_cv2_blocked():
    """The native I/O, every command and the dispatcher import with JAX,
    flax, the JAX package and `cv2` blocked."""
    blocked = FORBIDDEN + ("cv2",)
    mods = ["yolou_tpu_torch.__main__", "yolou_tpu_torch.native.loader",
            "yolou_tpu_torch.native.image"] + [
        f"yolou_tpu_torch.cli.{p.stem}" for p in sorted(
            (PKG / "cli").glob("*.py")) if p.stem != "__init__"]
    assert len(mods) == 3 + 12
    code = _BLOCK.format(blocked=blocked) + (
        "import importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "print('ok')\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_module_val_runs_with_cv2_blocked(tmp_path):
    """`python -m yolou_tpu_torch val <synthetic dir> --device cpu` with
    cv2 blocked: the PNGs are read by the port's own codec; the metrics
    are printed (fresh seeded weights: no model file)."""
    from yolou_tpu_torch.data import synthetic
    synthetic.generate(str(tmp_path), {"val": 3}, size=32, seed=2)
    code = _BLOCK.format(blocked=FORBIDDEN + ("cv2",)) + (
        "import runpy\n"
        f"sys.argv = ['yolou_tpu_torch', 'val', '--data', {str(tmp_path)!r},"
        " '--imgsz', '32', '--model', 'absent.ckpt', '--device', 'cpu']\n"
        "runpy.run_module('yolou_tpu_torch', run_name='__main__')\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    metrics = json.loads(res.stdout)
    assert set(metrics) == {"precision", "recall", "map50", "map"}


def test_export_profile_and_visualize_modules_import_with_jax_and_cv2_blocked():
    """The exporter, the profiling utilities and profiler, and the
    `export`, `profile` and `visualize-logits` commands import with JAX,
    flax, the JAX package and `cv2` blocked."""
    mods = ["engine.exporter", "cli.export", "cli.profile",
            "cli.visualize_logits", "utils.profiling",
            "tools.profile_layers"]
    code = _BLOCK.format(blocked=FORBIDDEN + ("cv2",)) + (
        "import importlib\n"
        f"for n in {mods!r}: importlib.import_module('yolou_tpu_torch.' + n)\n"
        "print('ok')\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_dryrun_and_demo_modules_import_with_jax_and_cv2_blocked():
    """`tools/dryrun.py` (the multi-rank dry run) and `tools/run_demo.py`
    (the four-stage demo, whose AUC reads masks without cv2) import with
    JAX, flax, the JAX package and `cv2` blocked."""
    code = _BLOCK.format(blocked=FORBIDDEN + ("cv2",)) + (
        "from yolou_tpu_torch.tools import dryrun, run_demo\n"
        "assert callable(dryrun.dryrun_multichip)\n"
        "assert callable(run_demo.objectmap_auc)\n"
        "print('ok')\n")
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_module_export_runs_with_jax_blocked(tmp_path):
    """`python -m yolou_tpu_torch export --device cpu` (fresh seeded
    weights at 32^2) with JAX, flax, the JAX package and `cv2` blocked; the
    artifact loads and runs in the same process, JAX still blocked."""
    out = str(tmp_path / "exported")
    code = _BLOCK.format(blocked=FORBIDDEN + ("cv2",)) + f"""
import runpy
import numpy as np
sys.argv = ['yolou_tpu_torch', 'export', '--model', 'absent.ckpt', '--out',
            {out!r}, '--imgsz', '32', '--device', 'cpu']
try:
    runpy.run_module('yolou_tpu_torch', run_name='__main__')
except SystemExit as e:
    assert e.code == 0, e.code
from yolou_tpu_torch.engine.exporter import ExportedModel
res = ExportedModel({out!r})(np.zeros((1, 32, 32, 4), np.uint8))
print(len(res), tuple(res[0].shape))
"""
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.splitlines()[-1] == "6 (1, 300, 4)"
    assert sorted(os.listdir(out)) == ["meta.json", "program.pt2",
                                       "weights.msgpack"]


def test_cuda_tensor_with_no_build_raises_without_the_plain_version(
        monkeypatch, tmp_path):
    """Each operator's real version, given CUDA tensors (fake ones: this
    build of torch has no CUDA) where the kernels cannot be built: it
    raises the build's error, runs no plain version and counts no launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from yolou_tpu_torch.kernels import a2c2f, attention, nms

    def missing():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def plain(*args, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(build, "_lib", None)
    monkeypatch.setattr(build, "_nvcc", missing)
    monkeypatch.setattr(build, "library_path", lambda: tmp_path / "lib.so")
    for mod, name in ((attention, "area_attention_qkv_fused_plain"),
                      (attention, "area_attention_fused_plain"),
                      (nms, "suppress_greedy_plain"),
                      (a2c2f, "a2c2f_fused_plain")):
        monkeypatch.setattr(mod, name, plain)
    shapes = [(8, 32), (32,)] + [(32, 96), (96,), (7, 7, 32), (32,),
                                 (32, 32), (32,), (32, 64), (64,), (64, 32),
                                 (32,)] * 2 + [(64, 16), (16,)]
    with FakeTensorMode():
        t = {s: torch.empty(s, device="cuda") for s in
             [(2, 9, 64), (64, 192), (192,), (2, 9, 32), (1, 4, 4),
              (1, 4, 4, 8)]}
        valid = torch.ones(1, 4, dtype=torch.bool, device="cuda")
        ws = [torch.empty(s, device="cuda") for s in shapes]
    x = t[(2, 9, 64)]
    assert x.device.type == "cuda"
    kernels.reset_launch_counts()
    calls = [
        lambda: attention._qkv_attention_forward(x, t[(64, 192)],
                                                 t[(192,)], 2),
        lambda: attention._band_attention(x, x, x, 2,
                                          attention.area_attention_fused),
        lambda: attention._band_attention(t[(2, 9, 32)], t[(2, 9, 32)],
                                          t[(2, 9, 32)], 1,
                                          attention.area_attention),
        lambda: nms._greedy_nms_forward(t[(1, 4, 4)], valid, 0.45),
        lambda: a2c2f._a2c2f_forward(t[(1, 4, 4, 8)], ws, 1, 1, 1)]
    for call in calls:
        try:
            call()
        except RuntimeError as e:
            assert "nvcc not found" in str(e), e
        else:
            raise AssertionError("a CUDA tensor ran without a kernel")
    assert not any(kernels.launch_counts().values())


def test_families_build_and_cross_files_with_jax_blocked(tmp_path):
    """The yolov8 and yolo11 graphs (their blocks, the legacy head, PSA)
    build seeded, run a forward at 32^2 and cross a `.ckpt` file with JAX,
    flax, the JAX package and `cv2` blocked; the file names the family."""
    code = _BLOCK.format(blocked=FORBIDDEN + ("cv2",)) + f"""
import json, os
import torch
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.utils.checkpoint import load_checkpoint
from yolou_tpu_torch.utils.model_io import load_model, save_model
x = torch.rand(1, 4, 32, 32, generator=torch.Generator().manual_seed(0))
for arch in ("yolov8", "yolo11"):
    m = build_yolo(arch, "n", nc=1, ch=4, task="segment", device="cpu",
                   seed=1)
    path = os.path.join({str(tmp_path)!r}, arch + ".ckpt")
    save_model(path, m)
    back = load_model(path, device="cpu")
    assert json.loads(load_checkpoint(path)["meta_json"])["arch"] == arch
    with torch.no_grad():
        assert torch.equal(m(x).preds, back(x).preds)
print("ok")
"""
    res = _run(code, REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
