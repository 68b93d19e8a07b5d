"""Time the band attention kernels, the whole-A2C2f kernel and the greedy
NMS kernel as built from several `csrc` directories, in turns, on one GPU.

    python -m yolou_tpu_torch.tools.time_builds OLD_CSRC NEW_CSRC [--out F]
        [--cases SUBSTRING]

Each directory is compiled with `kernels/build.py`'s flags into its own
library (`_build/`, named by the hash of its sources); the package's wrappers
then launch each library's kernels on the same seeded bfloat16 inputs, at
the shapes the serving, training and evaluation paths and the attention
profiler give them (batch 8 at 640^2, batch 16 at 160^2; NMS over 512
candidates of 8 and of 16 images, all valid). A `csrc` from before the
one-launch NMS kernel, whose C entry still takes a hit-matrix scratch, gets
that scratch allocated here. The builds take
turns in the order given and then in reverse (old, new, new, old for two), so
a drift of the card's clock over the run shows as a spread and not as a
difference. Prints one JSON object: case -> directory -> {"device_ms":
[...], "call_ms": [...]}, one number per turn: the card's own time per call
(torch.profiler, `profile_layers.device_ms`) and CUDA events around
back-to-back calls (`profile_layers.call_ms`, which counts the host too
where it sets the pace), each over `--iters` calls after 3 warm-up calls.
Compare two builds only within one run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path

import numpy as np
import torch

from ..kernels import build
from ..kernels.a2c2f import a2c2f_fused
from ..kernels.nms import suppress_greedy
from ..kernels.attention import area_attention, area_attention_fused, \
    area_attention_qkv_fused
from .profile_layers import call_ms, device_ms

# name, (G, N, C), heads
QKV_CASES = [("A L6@640", (32, 400, 64), 2), ("A L8@640", (8, 400, 128), 4),
             ("A L6@160", (64, 25, 64), 2), ("A L8@160", (16, 25, 128), 4)]
ATTN_CASES = [("C L6@640", (32, 400, 64), 2), ("C L8@640", (8, 400, 128), 4),
              ("C profile-fused", (32, 400, 128), 4),
              ("C profile-single", (128, 400, 32), 1),
              ("C single", (64, 400, 32), 1)]
# name, (B, H, W, cin), c2, stages, area, heads
A2C2F_CASES = [("a2c2f L6@640", (8, 40, 40, 128), 128, 2, 4, 2),
               ("a2c2f L8@640", (8, 20, 20, 256), 256, 2, 1, 4)]
# name, (B, K): the serving request and the evaluation step's batch
NMS_CASES = [("B (8,512)", (8, 512)), ("B (16,512)", (16, 512))]
NMS_IOU = 0.45


def load_library(csrc: Path):
    """Build (if needed) and load the kernels of one `csrc` directory. A
    library whose NMS entry takes the hit-matrix scratch (the two-launch
    kernel) is marked `nms_hit_scratch` and given that entry's signature."""
    saved = build.CSRC, build._lib
    try:
        build.CSRC, build._lib = csrc.resolve(), None
        lib = build.load()
    finally:
        build.CSRC, build._lib = saved
    nms_source = (csrc / "greedy_nms.cu").read_text()
    lib.nms_hit_scratch = "nms_hit_kernel" in nms_source
    if lib.nms_hit_scratch:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.yolou_greedy_nms.argtypes = [vp, vp, vp, vp, ci, ci,
                                         ctypes.c_float, vp]
    return lib


def _nms(boxes, valid):
    """suppress_greedy through the active library; the two-launch kernel's
    entry gets its (B, K, ceil(K / 64)) scratch of 64-bit words."""
    lib = build._lib
    if not getattr(lib, "nms_hit_scratch", False):
        return suppress_greedy(boxes, valid, NMS_IOU)
    bsz, k = valid.shape
    hit = torch.empty((bsz, k, -(-k // 64)), dtype=torch.int64,
                      device=boxes.device)
    keep = torch.empty_like(valid)
    stream = torch.cuda.current_stream().cuda_stream
    code = lib.yolou_greedy_nms(boxes.data_ptr(), valid.data_ptr(),
                                hit.data_ptr(), keep.data_ptr(), bsz, k,
                                NMS_IOU, stream)
    build.check(lib, code, "greedy NMS kernel")
    return keep


def _calls(device):
    """case name -> a call of the package's wrapper on seeded inputs."""
    rng = np.random.default_rng(0)

    def mk(shape, std=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(rng.normal(0, std, shape).astype(np.float32)
                                ).to(device, dtype)

    calls = {}
    for name, (g, n, c), heads in QKV_CASES:
        x, w, b = mk((g, n, c)), mk((c, 3 * c), 0.5 / np.sqrt(c)), mk(
            (3 * c,), 0.1, torch.float32)
        calls[name] = lambda x=x, w=w, b=b, h=heads: area_attention_qkv_fused(
            x, w, b, h)
    for name, shape, heads in ATTN_CASES:
        q, k, v = mk(shape), mk(shape), mk(shape)
        calls[name] = (lambda q=q, k=k, v=v: area_attention(q, k, v)) \
            if heads == 1 else \
            (lambda q=q, k=k, v=v, h=heads: area_attention_fused(q, k, v, h))

    def gemm(k, n):                  # a (k, n) weight and its f32 bias
        return [mk((k, n), 0.5 / np.sqrt(k)), mk((n,), 0.1, torch.float32)]

    for name, shape, c2, stages, area, heads in A2C2F_CASES:
        c_ = c2 // 2
        ws = gemm(shape[-1], c_)
        for _ in range(2 * stages):    # qkv, 7x7 positional term, proj, MLP
            ws += (gemm(c_, 3 * c_) + [mk((7, 7, c_), 0.1, torch.float32),
                                       mk((c_,), 0.1, torch.float32)]
                   + gemm(c_, c_) + gemm(c_, 2 * c_) + gemm(2 * c_, c_))
        ws += gemm((stages + 1) * c_, c2)
        x = mk(shape)
        calls[name] = lambda x=x, ws=ws, s=stages, a=area, h=heads: \
            a2c2f_fused(x, ws, s, a, h)
    for name, (bsz, k) in NMS_CASES:   # chip_smoke.py's "random" boxes
        xy = rng.random((bsz, k, 2), np.float32) * 600
        wh = rng.random((bsz, k, 2), np.float32) * 120 + 8
        boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)).to(device)
        valid = torch.ones((bsz, k), dtype=torch.bool, device=device)
        calls[name] = lambda b=boxes, v=valid: _nms(b, v)
    return calls


def time_builds(dirs, iters: int = 20, cases: str = ""):
    """case -> directory -> {"device_ms": [...], "call_ms": [...]}, for the
    cases whose name contains `cases` (all by default)."""
    device = torch.device("cuda", 0)
    libs = [load_library(Path(d)) for d in dirs]
    calls = {k: v for k, v in _calls(device).items() if cases in k}
    order = list(range(len(dirs))) + list(reversed(range(len(dirs))))
    times = {name: {d: {"device_ms": [], "call_ms": []} for d in dirs}
             for name in calls}
    saved = build._lib
    try:
        with torch.no_grad():
            for i in order:
                build._lib = libs[i]
                for name, fn in calls.items():
                    t = times[name][dirs[i]]
                    t["device_ms"].append(device_ms(fn, iters))
                    t["call_ms"].append(call_ms(fn, device, iters))
    finally:
        build._lib = saved
    return times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+", help="csrc directories, oldest first")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cases", default="",
                    help="only the cases whose name contains this")
    ap.add_argument("--out", help="also write the JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("time_builds needs a CUDA device")
    times = time_builds(args.dirs, args.iters, args.cases)
    text = json.dumps(times)
    if args.out:
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)


if __name__ == "__main__":
    main()
