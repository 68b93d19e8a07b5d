"""The yardstick's counts against hand counts, on the CPU: the operations
FlopCounterMode gives one convolution and one band attention of the
reference, kernel A's bytes and operations and its bound, a greedy NMS
call, the trace's reduction, and the import check.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import sys
import types

import pytest
import torch

from benchmark import layers, roofline, run
from benchmark.reference import nms as ref_nms
from benchmark.reference.yolo import AAttn, Conv
from benchmark.trace import Trace, _merge


def test_conv_flops_by_hand():
    conv = Conv(16, 32, 3, 2).eval()
    x = torch.randn(2, 16, 20, 20)
    # 2 operations a multiply-add: B * Cout * Ho * Wo * Cin * k * k
    assert roofline.counted_flops(lambda: conv(x)) == 2 * 2 * 32 * 10 * 10 * 16 * 9


def test_band_attention_flops_by_hand():
    """AAttn at 8x8 tokens in 4 bands of 16, 2 heads of 32: the qkv, proj
    and 7x7 depthwise convs, and q.k^T and p.v (4 N^2 C a band)."""
    dim, heads, area, b, h, w = 64, 2, 4, 1, 8, 8
    attn = AAttn(dim, heads, area).eval()
    x = torch.randn(b, dim, h, w)
    n = h * w
    convs = 2 * b * n * (dim * 3 * dim + dim * dim + dim * 49)
    attention = 4 * (b * area) * (n // area) ** 2 * dim
    assert roofline.counted_flops(lambda: attn(x)) == convs + attention


def test_kernel_a_work_and_bound():
    # yolov12s layer 6 at 640^2, batch 64: 256 bands of 400 tokens, C 128
    g, n, c = 256, 400, 128
    nbytes, flops = roofline.band_attention_qkv_work(g, n, c, 4, "bfloat16")
    assert nbytes == 2 * (g * n * c + 3 * c * c + 2 * g * n * c) + 12 * c
    assert flops == 6 * g * n * c * c + 4 * g * n * n * c
    least = roofline.bound_s(nbytes, flops, "bfloat16")
    assert least == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))
    assert roofline.share(least, 2 * least) == pytest.approx(50.0)


def test_peaks():
    assert roofline.peak_name("bfloat16", True) == "bfloat16"
    assert roofline.peak_name("float32", True) == "tf32"
    assert roofline.peak_name("float32", False) == "float32"
    assert roofline.PEAK_FLOPS == {"bfloat16": 989e12, "tf32": 495e12,
                                   "float32": 67e12}


def test_nms_call_by_hand():
    """Three boxes of one class: the second overlaps the first (IoU 0.81 >
    0.45) and is suppressed, the third is apart; a fourth scores under the
    confidence gate."""
    p = torch.tensor([[[10., 10., 10., 10., 0.9],
                       [10.5, 10., 10., 10., 0.8],
                       [40., 40., 10., 10., 0.7],
                       [70., 70., 10., 10., 0.2]]])
    out = ref_nms.nms(p, nc=1, max_det=4)
    assert out["valid"].tolist() == [[True, True, False, False]]
    assert out["conf"][0, :2].tolist() == pytest.approx([0.9, 0.7])
    assert out["boxes"][0, 1].tolist() == [35., 35., 45., 45.]
    assert roofline.counted_flops(lambda: ref_nms.nms(p, nc=1)) == 0


class _Event:
    """A stand-in of a kineto event."""

    def __init__(self, name, start, end, cuda=False, corr=0, linked=0,
                 shapes=(), dtypes=(), scalars=()):
        self._v = (name, start, end, cuda, corr, linked, shapes, dtypes,
                   scalars)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def end_ns(self): return self._v[2]
    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._v[3]
                else torch.autograd.DeviceType.CPU)
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def is_user_annotation(self): return False
    def shapes(self): return list(self._v[6])
    def dtypes(self): return list(self._v[7])
    def concrete_inputs(self): return list(self._v[8])


def test_trace_reduction_by_hand():
    """One request span of 100 ns: an op with two kernels (20 + 10 ns,
    overlapping by 5), a copy of 10 ns; busy 35 ns, 2 kernels."""
    ev = [_Event("bench.request", 0, 100),
          _Event("yolou::band_attention_qkv", 10, 30, corr=7,
                 shapes=[[4, 25, 64], [64, 192], [192], []],
                 dtypes=["float", "float", "float", "Scalar"],
                 scalars=["", "", "", 2]),
          _Event("aten::copy_", 40, 50, corr=8),
          _Event("kernel_x", 20, 40, cuda=True, linked=7),
          _Event("kernel_y", 35, 45, cuda=True, linked=7),
          _Event("Memcpy DtoH", 60, 70, cuda=True, linked=8)]
    tr = Trace(ev, 1)
    assert tr.window_s == pytest.approx(100e-9)
    assert tr.busy_s == pytest.approx(35e-9)
    assert tr.kernels == 2
    seconds, calls = tr.op_device("yolou::band_attention_qkv")
    assert seconds == pytest.approx(30e-9) and len(calls) == 1
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["kernel_x", pytest.approx(20e-9)]
    idle = dict(bd["idle_gaps"])
    # gaps: 0-20 (mid 10, the op starts at 10), 45-60 and 70-100 (the span)
    assert idle["yolou::band_attention_qkv"] == pytest.approx(20e-9)
    assert idle["bench.request"] == pytest.approx(45e-9)
    ctx = {"trace": tr, "images_per_request": 4, "window_s": 1e-6,
           "requests": 10, "flops_per_request": 495e3, "peak": "tf32"}
    # busy and wall both the stretch's: 35 of 100 ns
    assert layers.idle_share(ctx) == pytest.approx(65.0)
    assert layers.launches_per_image(ctx) == pytest.approx(0.5)
    assert layers.mfu(ctx) == pytest.approx(
        100 * 495e3 * 10 / 1e-6 / 495e12)
    nbytes, flops = roofline.band_attention_qkv_work(4, 25, 64, 2, "float32")
    assert layers.band_attention_qkv_roofline(
        ctx, "yolou::band_attention_qkv") == pytest.approx(
        100 * roofline.bound_s(nbytes, flops, "float32") / 30e-9)
    assert layers.op_ms_per_call(ctx, "yolou::greedy_nms") is None


def test_closed_loop_window_and_statistics():
    """Requests back to back until the window's seconds are up; the
    statistics over all of them."""
    from benchmark.drivers import ClosedLoop

    class Fake(ClosedLoop):
        images_per_request = 3

        def __init__(self):
            self.seen = []

        def request(self, i):
            self.seen.append(i)
    drv = Fake()
    w = drv.window(5, 0.01)
    assert drv.seen == list(range(5, w.next)) and w.requests == len(drv.seen)
    assert w.images == 3 * w.requests and w.wall_s >= 0.01
    st = drv.statistics(w)
    assert st["images_per_s"] == pytest.approx(w.images / w.wall_s)
    assert st["latency_p95_ms"] >= 0


def test_merge():
    assert _merge([(5, 9), (0, 3), (2, 4), (9, 10)]) == [(0, 4), (5, 10)]


def test_import_check_compares_whole_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "yolou_tpu_torch_extra",
                        types.ModuleType("yolou_tpu_torch_extra"))
    assert run.forbidden_modules() == []
    for name in ("jax", "jaxlib.xla_client", "flax", "optax",
                 "yolou_tpu.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == ["flax", "jax", "jaxlib", "optax",
                                       "yolou_tpu"]


def test_benchmark_sources_import_no_jax():
    """No file of the benchmark names JAX or the JAX package in an import
    (the run's own check covers what the program loads)."""
    import ast
    bad = []
    for path in run.BENCH.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] in run.FORBIDDEN]
    assert bad == []


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (run.BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                assert not (node.module or "").startswith("yolou_tpu")
            elif isinstance(node, ast.Import):
                assert not any(a.name.startswith("yolou_tpu")
                               for a in node.names)
