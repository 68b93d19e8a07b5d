"""Time the band attention kernels, the whole-A2C2f kernel and the greedy
NMS kernel as built from several `csrc` directories, in turns, on one GPU.

    python -m yolou_tpu_torch.tools.time_builds OLD_CSRC NEW_CSRC [--out F]
        [--cases SUBSTRING] [--tiles 64,32]

Each directory is compiled with `kernels/build.py`'s flags into its own
library (`_build/`, named by the hash of its sources); the package's wrappers
then launch each library's kernels on the same seeded bfloat16 inputs, at
the shapes the serving, training and evaluation paths and the attention
profiler give them (batch 8 at 640^2, batch 16 at 160^2; NMS over 512
candidates of 1, 8 and 16 images and 2048 of 8, all valid; kernel A
also at heads of 64 on 25 tokens, its short form at 64), kernels A
and C on the path this tree plans (at 400 tokens the streamed one, at 25
kernel A's short one: every tree from kernel A's short path on has both);
then kernels A and C forced onto the streamed path (the "streamed" cases:
f32 at the default commands' batch 16 at 640^2 and 160^2, at batch 8 and
at 1024^2 and 1280^2, bf16 at the bands it serves and the long ones); then
kernels A and C on their tree's planned path at the 160^2 bands (the
"planned" cases, kernel C at the fine-tune's batch 16 and a 2 x 2 mesh's
data shard of 8: the short path where the library has kernel C's, else
the paths before it, bf16 resident by its C entry and f32 streamed), and
kernel C's blocked form at two heads of 128, 256 and 512 over bands of
400, batch 8 (the "blocked" cases, f32 and at 128 bf16). `--tiles` adds
each whole-A2C2f case at each given token tile (the sweep behind
`kernels/a2c2f.py::f32_tile`'s rule, which both types use). The
bf16 strip case's plain version is timed too ("a2c2f L6 strip plain", the
same plain tensor code beside every tree's kernel).
A `csrc` from before the whole-A2C2f kernel took its MLP width (whose C
entry has no `hid`) is called without it, one whose streamed entries take
no query rows (before the TMA kernels) without those, and one from before heads of any
width and any stage count without the scale, the block array, the f32
scratch and tile; one from before the bf16 wgmma kernel (no
`a2c2f_bf16.cu`) gets its bf16 weights unpacked. The builds take
turns in the order given and then in reverse (old, new, new, old for two), so
a drift of the card's clock over the run shows as a spread and not as a
difference. Prints one JSON object: case -> directory -> {"device_ms":
[...], "call_ms": [...]}, one number per turn: the card's own time per call
(torch.profiler's device events, as `profile_layers.device_ms` sums them)
and CUDA events around back-to-back calls (`profile_layers.call_ms`, which
counts the host too where it sets the pace), each over `--iters` calls
after 3 warm-up calls; "events_per_call", the device events a call in
that trace (a turn short of events reads low); kernel A's streamed cases
also "projection_ms", its first device kernel's (the k/v projection) share
of the device time, from the same trace. Compare two builds only within one run.

`nms_bounds()` gives the NMS cases' bound, on any device: the least time
the card could take, the larger of the bytes moved over 3.35 TB/s and 16
f32 operations per IoU test this data needs (each kept box against every
later candidate) over 67 TFLOP/s, as `chip_smoke.py` counts them; and the
hops of the kernel's chain between owner CTAs (`chip_smoke.py` times a call
with no valid row beside it, the chain's own floor):

    python -c "from yolou_tpu_torch.tools.time_builds import nms_bounds; \
print(nms_bounds())"
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import sys
from pathlib import Path

import numpy as np
import torch

from ..kernels import a2c2f as a2c2f_module
from ..kernels import build
from ..kernels.a2c2f import _launch_a2c2f, a2c2f_fused, a2c2f_fused_plain
from ..kernels.attention import (_launch_band_attention,
                                 _launch_qkv_attention, area_attention_fused,
                                 area_attention_qkv_fused)
from ..kernels.nms import suppress_greedy
from .profile_layers import call_ms

# name, (G, N, C), heads
QKV_CASES = [("A L6@640", (32, 400, 64), 2), ("A L8@640", (8, 400, 128), 4),
             ("A L6@160", (64, 25, 64), 2), ("A L8@160", (16, 25, 128), 4),
             ("A L6@160 hd64", (64, 25, 128), 2)]   # the short form at 64
ATTN_CASES = [("C L6@640", (32, 400, 64), 2), ("C L8@640", (8, 400, 128), 4),
              ("C profile-fused", (32, 400, 128), 4),
              ("C profile-single", (128, 400, 32), 1),
              ("C single", (64, 400, 32), 1)]
# name, kernel, (G, N, C), heads, dtype: the streamed path forced
STREAM_CASES = [
    (f"{k} streamed f32 {name}", k, shape, heads, torch.float32)
    for k in ("A", "C")
    for name, shape, heads in (("L6@640b16", (64, 400, 64), 2),
                               ("L8@640b16", (16, 400, 128), 4),
                               ("L6@160b16", (64, 25, 64), 2),
                               ("L8@160b16", (16, 25, 128), 4))] + [
    ("C streamed f32 L6@1024", "C", (32, 1024, 64), 2, torch.float32),
    ("A streamed bf16 L6@640", "A", (32, 400, 64), 2, torch.bfloat16),
    ("A streamed bf16 L8@640", "A", (8, 400, 128), 4, torch.bfloat16),
    ("A streamed bf16 s L8@640", "A", (8, 400, 256), 8, torch.bfloat16),
    ("A streamed bf16 x L8@640", "A", (8, 400, 384), 12, torch.bfloat16),
    ("A streamed bf16 L6@160b128", "A", (512, 25, 64), 2, torch.bfloat16),
    ("A streamed bf16 L8@160b128", "A", (128, 25, 128), 4, torch.bfloat16),
    ("A streamed bf16 L6@1280", "A", (32, 1600, 64), 2, torch.bfloat16),
    ("A streamed bf16 L8@1280", "A", (8, 1600, 128), 4, torch.bfloat16),
    ("C streamed bf16 L6@1408", "C", (32, 1936, 64), 2, torch.bfloat16),
    # the f32 k/v projection's first launch at batch 8 and 1280^2
    ("A streamed f32 L6@640", "A", (32, 400, 64), 2, torch.float32),
    ("A streamed f32 L8@640", "A", (8, 400, 128), 4, torch.float32),
    ("A streamed f32 L6@1280", "A", (32, 1600, 64), 2, torch.float32)]
# name, kernel, (G, N, C), heads, dtype: kernels A and C on their tree's
# planned path at the 160^2 bands (kernel A: evaluation at batch 16,
# objectmaps at 128; kernel C: the fine-tune at 16, a 2 x 2 mesh's data
# shard at 8)
PLANNED_CASES = [
    (f"{k} planned {dt} {name}", k, shape, heads, dtype)
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
    for k, name, shape, heads in (
        ("A", "L6@160b16", (64, 25, 64), 2),
        ("A", "L8@160b16", (16, 25, 128), 4),
        ("A", "L6@160b128", (512, 25, 64), 2),
        ("A", "L8@160b128", (128, 25, 128), 4),
        ("C", "L6@160b16", (64, 25, 64), 2),
        ("C", "L8@160b16", (16, 25, 128), 4),
        ("C", "L6@160b8", (32, 25, 64), 2),
        ("C", "L8@160b8", (8, 25, 128), 4))] + [
    # kernel C's blocked form (heads wider than 64) at two heads of 128,
    # 256 and 512 on bands of 400 tokens, batch 8
    (f"C blocked {dt} hd{c // 2}", "C", (8, 400, c), 2, dtype)
    for dt, dtype, widths in (("f32", torch.float32, (256, 512, 1024)),
                              ("bf16", torch.bfloat16, (256,)))
    for c in widths]
# name, (B, H, W, cin), c2, stages, area, heads, MLP width (None: 2 c_;
# bf16 a multiple of 16, as the fold pads it), dtype: yolov12n's layers 6
# and 8 at 640^2 (mlp_ratio 2 and 1.2), A2C2f(96, 96) (one head of 48,
# padded to 64), five stages and layer 6 of a 1600 x 256 strip (images too
# wide for the bf16 kernel's staged stencil rows) in bf16, layers 6 and 8
# in f32
A2C2F_CASES = [
    ("a2c2f L6@640", (8, 40, 40, 128), 128, 2, 4, 2, None, torch.bfloat16),
    ("a2c2f L8@640", (8, 20, 20, 256), 256, 2, 1, 4, None, torch.bfloat16),
    ("a2c2f L6@640 mlp1.2", (8, 40, 40, 128), 128, 2, 4, 2, 80,
     torch.bfloat16),
    ("a2c2f L8@640 mlp1.2", (8, 20, 20, 256), 256, 2, 1, 4, 160,
     torch.bfloat16),
    ("a2c2f A2C2f(96,96)", (8, 20, 20, 96), 96, 1, 1, 1, None,
     torch.bfloat16),
    ("a2c2f n5", (2, 20, 20, 128), 128, 5, 1, 2, None, torch.bfloat16),
    ("a2c2f L6 strip", (8, 16, 100, 128), 128, 2, 4, 2, None,
     torch.bfloat16),
    ("a2c2f f32 L6@640", (8, 40, 40, 128), 128, 2, 4, 2, None, torch.float32),
    ("a2c2f f32 L8@640", (8, 20, 20, 256), 256, 2, 1, 4, None, torch.float32)]
# the a2c2f cases whose plain version is timed too ("... plain": the same
# call in every tree, a yardstick beside the kernel; chip_smoke.py times the
# others')
A2C2F_PLAIN = ("a2c2f L6 strip",)
# name, (B, K): chip_smoke.py's "random" boxes (most kept) at the serving
# batch and the evaluation step's, the serving request's candidates (the
# "serve" cases: its "dense" boxes, which keep few rows) at 8 images and at
# one, and "random" at the kernel's largest K; every row valid
NMS_CASES = [("B (8,512)", (8, 512)), ("B (16,512)", (16, 512)),
             ("B serve (8,512)", (8, 512)), ("B serve (1,512)", (1, 512)),
             ("B (8,2048)", (8, 2048))]
NMS_IOU = 0.45
# published peaks of one H100 SXM: HBM3 bytes/s, f32 FLOP/s outside the
# tensor cores
HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12


def load_library(csrc: Path):
    """Build (if needed) and load the kernels of one `csrc` directory. A
    library whose `yolou_a2c2f` has no MLP width gets an entry that drops it,
    and one from before heads of any width (no scale in the attention
    entries, no block array or tile in `yolou_a2c2f`) entries that drop
    those."""
    saved = build.CSRC
    try:
        build.CSRC = csrc.resolve()
        lib = build.bind(ctypes.CDLL(str(build.build())), missing_ok=True)
    finally:
        build.CSRC = saved
    vp, ci = ctypes.c_void_p, ctypes.c_int
    # the bf16 wgmma kernel (a2c2f_bf16.cu) takes its weights packed; the
    # trees before it (one a2c2f.cu) take them as they are (`_use`)
    lib.a2c2f_bf16_packed = (csrc / "a2c2f_bf16.cu").exists()
    a2c2f_source = "".join(f.read_text() for f in sorted(csrc.glob("a2c2f*")))
    if "const void* blocks" not in a2c2f_source:
        # before any stage count and head width: no block array, work
        # scratch, attention width, scale or f32 tile (the 18th-22nd of
        # the new entry's arguments); before the MLP width also no hid
        # (the 13th: ..., c_, c2, hid, n_stages, ...)
        hid = "int hid" in a2c2f_source
        entry = lib.yolou_a2c2f
        entry.argtypes = [vp, ctypes.POINTER(vp), ci, vp, vp, vp,
                          *[ci] * (11 if hid else 10), vp]
        keep = list(range(17)) if hid else [*range(12), *range(13, 17)]
        lib.yolou_a2c2f = lambda *args: entry(*(args[i] for i in keep),
                                              args[-1])
    if hasattr(lib, "yolou_band_attention"):
        # a tree from before kernel C's short path: its resident entry
        # (`_planned_attention`)
        lib.yolou_band_attention.argtypes = [vp] * 4 + [ci] * 5 + [
            ctypes.c_float, vp]
        lib.yolou_band_attention.restype = ci
    attention_source = (csrc / "band_attention.cu").read_text()
    if "float scale, void* stream" not in attention_source:
        # the entries' scale (the argument before the stream) dropped
        for name in ("yolou_band_attention",
                     "yolou_band_attention_qkv_stream",
                     "yolou_band_attention_stream"):
            if hasattr(lib, name):
                old = getattr(lib, name)
                old.argtypes = old.argtypes[:-2] + old.argtypes[-1:]
                setattr(lib, name, lambda *args, old=old:
                        old(*args[:-2], args[-1]))
    if "int rows" not in attention_source:
        # the entries' query rows (the 12th and 10th argument) dropped
        for name, at in (("yolou_band_attention_qkv_stream", 11),
                         ("yolou_band_attention_stream", 9)):
            if hasattr(lib, name):
                old = getattr(lib, name)
                old.argtypes = old.argtypes[:at] + old.argtypes[at + 1:]
                setattr(lib, name, lambda *args, old=old, at=at:
                        old(*args[:at], *args[at + 1:]))
    return lib


def _planned(kernel, args, heads):
    """Kernel A or C on the path this tree plans (on the CPU the wrapper:
    the plain version)."""
    fn = area_attention_qkv_fused if kernel == "A" else area_attention_fused
    if args[0].device.type == "cpu":
        return fn(*args, heads)
    if kernel == "A":
        return _launch_qkv_attention(*args, heads)
    return _launch_band_attention(*args, heads)


def _streamed(kernel, args, heads):
    """Kernel A or C forced onto the streamed path (on the CPU the wrapper:
    the plain version)."""
    if args[0].device.type == "cpu":
        fn = area_attention_qkv_fused if kernel == "A" else area_attention_fused
        return fn(*args, heads)
    if kernel == "A":
        return _launch_qkv_attention(*args, heads, "streamed")
    return _launch_band_attention(*args, heads, "streamed")


def _planned_attention(kernel, args, heads):
    """Kernel A or C on the path its tree plans at a band of 64 tokens or
    fewer: the short path where the loaded library has the kernel's short
    entry; else kernel C's paths before it, the bf16 resident kernel
    (called by its C entry, which this tree's wrappers do not name) and
    the f32 streamed one. On the CPU the wrapper."""
    q = args[0]
    if q.device.type == "cpu" or kernel == "A" or hasattr(
            build._lib, "yolou_band_attention_short"):
        return _planned(kernel, args, heads)
    if q.dtype == torch.float32:
        return _launch_band_attention(*args, heads, "streamed")
    lib, (g, n, c) = build._lib, q.shape
    o = torch.empty_like(q)
    code = lib.yolou_band_attention(
        *(t.data_ptr() for t in (*args, o)), g, n, c, heads, 1,
        (c // heads) ** -0.5, torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "resident kernel C")
    return o


def _a2c2f_at_tile(x, ws, stages, area, heads, tile):
    """The whole-block kernel at token tile `tile` (on the CPU the wrapper:
    the plain version)."""
    if x.device.type == "cpu":
        return a2c2f_fused(x, ws, stages, area, heads)
    return _launch_a2c2f(x, ws, stages, area, heads, tile=tile)


def _calls(device, tiles=()):
    """case name -> a call of the package's wrapper on seeded inputs; each
    a2c2f case also at each token tile of `tiles` ("... tile64")."""
    rng = np.random.default_rng(0)

    def mk(shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(device, dtype)

    calls = {}
    def operands(kernel, shape, dtype=torch.bfloat16):
        g, n, c = shape
        if kernel == "A":
            return (mk(shape, dtype=dtype),
                    mk((c, 3 * c), 0.5 / np.sqrt(c), dtype),
                    mk((3 * c,), 0.1, torch.float32))
        return tuple(mk(shape, dtype=dtype) for _ in range(3))

    for name, shape, heads in QKV_CASES:
        calls[name] = functools.partial(_planned, "A", operands("A", shape),
                                        heads)
    for name, shape, heads in ATTN_CASES:
        calls[name] = functools.partial(_planned, "C", operands("C", shape),
                                        heads)
    for name, kernel, shape, heads, dtype in STREAM_CASES:
        calls[name] = functools.partial(_streamed, kernel,
                                        operands(kernel, shape, dtype), heads)
    for name, kernel, shape, heads, dtype in PLANNED_CASES:
        calls[name] = functools.partial(_planned_attention, kernel,
                                        operands(kernel, shape, dtype), heads)

    for name, shape, c2, stages, area, heads, hid, dtype in A2C2F_CASES:
        def gemm(k, n, dtype=dtype):  # a (k, n) weight and its f32 bias
            return [mk((k, n), 0.5 / np.sqrt(k), dtype),
                    mk((n,), 0.1, torch.float32)]

        c_ = c2 // 2
        hid = 2 * c_ if hid is None else hid
        ws = gemm(shape[-1], c_)
        for _ in range(2 * stages):    # qkv, 7x7 positional term, proj, MLP
            ws += (gemm(c_, 3 * c_) + [mk((7, 7, c_), 0.1, torch.float32),
                                       mk((c_,), 0.1, torch.float32)]
                   + gemm(c_, c_) + gemm(c_, hid) + gemm(hid, c_))
        ws += gemm((stages + 1) * c_, c2)
        x = mk(shape, dtype=dtype)
        calls[name] = lambda x=x, ws=ws, s=stages, a=area, h=heads: \
            a2c2f_fused(x, ws, s, a, h)
        if name in A2C2F_PLAIN:
            calls[f"{name} plain"] = functools.partial(
                a2c2f_fused_plain, x, ws, stages, area, heads)
        for tile in tiles:
            calls[f"{name} tile{tile}"] = functools.partial(
                _a2c2f_at_tile, x, ws, stages, area, heads, tile)
    for name, (bsz, k) in NMS_CASES:   # chip_smoke.py's boxes
        if "serve" in name:            # "dense"
            xy = rng.random((bsz, k, 2), np.float32) * 40 + 300
            wh = rng.random((bsz, k, 2), np.float32) * 60 + 20
        else:
            xy = rng.random((bsz, k, 2), np.float32) * 600
            wh = rng.random((bsz, k, 2), np.float32) * 120 + 8
        boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(device)
        valid = torch.ones((bsz, k), dtype=torch.bool, device=device)
        calls[name] = functools.partial(suppress_greedy, boxes, valid,
                                        NMS_IOU)
    return calls


def nms_bounds(device: str = "cpu"):
    """NMS case -> {kept, iou_tests, bytes, bound_ms, bound_by,
    chain_hops} on the inputs `_calls` times: the boxes and valid mask read
    once, the keep mask written once; the keep-set is the plain version's
    on the CPU (the kernel's, identical, on the card); the kernel's chain
    passes between ceil(K / 512) owner CTAs."""
    out = {}
    for name, fn in _calls(torch.device(device)).items():
        if not name.startswith("B "):
            continue
        boxes, valid, _ = fn.args
        keep = fn()
        bsz, k = valid.shape
        later = (k - 1 - torch.arange(k, device=keep.device)).expand(bsz, k)
        tests = int(later[keep].sum())
        nbytes = boxes.numel() * 4 + 2 * valid.numel()
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = 16 * tests / F32_FLOPS * 1e3
        out[name] = {"kept": int(keep.sum()), "iou_tests": tests,
                     "bytes": nbytes, "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "chain_hops": -(-k // 512) - 1}
    return out


_PACK_BF16 = a2c2f_module.pack_bf16_weight


def _use(lib):
    """Make `lib` the wrappers' library: its bf16 GEMM weights packed, or
    passed as they are to a tree from before the wgmma kernel, and no
    weight list kept from another library."""
    build._lib = lib
    a2c2f_module.pack_bf16_weight = (
        _PACK_BF16 if getattr(lib, "a2c2f_bf16_packed", True)
        else (lambda w: w))
    a2c2f_module._prepared.clear()


def device_kernel_ms(fn, iters: int = 20, warmup: int = 3):
    """(device milliseconds per call of `fn` by device kernel name, device
    events per call): the raw device events of one torch.profiler trace
    over `iters` calls after `warmup` (their time's sum is
    `profile_layers.device_ms`); a trace short of events shows as fewer
    events a call than the call launches."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):         # a trace that comes back empty is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out, events = {}, 0
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                out[e.name()] = (out.get(e.name(), 0.0)
                                 + e.duration_ns() / 1e6 / iters)
                events += 1
        if out:
            return out, events / iters
    raise RuntimeError("torch.profiler recorded no device time")


def time_builds(dirs, iters: int = 20, cases: str = "", tiles=()):
    """case -> directory -> {"device_ms": [...], "call_ms": [...]}, for the
    cases whose name contains `cases` (all by default), the a2c2f cases
    also at each token tile of `tiles`."""
    device = torch.device("cuda", 0)
    libs = [load_library(Path(d)) for d in dirs]
    calls = {k: v for k, v in _calls(device, tiles).items() if cases in k}
    order = list(range(len(dirs))) + list(reversed(range(len(dirs))))
    times = {name: {d: {"device_ms": [], "call_ms": []} for d in dirs}
             for name in calls}
    saved = build._lib
    try:
        with torch.no_grad():
            for i in order:
                _use(libs[i])
                for name, fn in calls.items():
                    print(f"time_builds: {dirs[i]} {name}", file=sys.stderr,
                          flush=True)
                    t = times[name][dirs[i]]
                    kernel_ms, events = device_kernel_ms(fn, iters)
                    t["device_ms"].append(sum(kernel_ms.values()))
                    t.setdefault("events_per_call", []).append(events)
                    if name.startswith("A streamed"):
                        t.setdefault("projection_ms", []).append(sum(
                            v for k, v in kernel_ms.items()
                            if "projection" in k))
                    t["call_ms"].append(call_ms(fn, device, iters))
    finally:
        _use(saved)
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="csrc directories, oldest first")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="",
                    help="only the cases whose name contains this")
    ap.add_argument("--tiles", default="",
                    help="also time each a2c2f case at these token tiles "
                         "(comma-separated, e.g. 64,32)")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_builds needs a CUDA device")
    tiles = tuple(int(t) for t in args.tiles.split(",") if t)
    times = time_builds(args.dirs, args.iters, args.cases, tiles)
    text = json.dumps(times)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
