"""Attention-variant profiler.

Counterpart of the `--attn` half of `yolou_tpu/tools/profile_layers.py`: at
the layer-6 attention shapes of YOLOv12 (area 4, N = 400 tokens a band, 4
heads of 32) it times the competing implementations of the band softmax
attention: the hand-written kernel in its single-head form over
(B*area*heads, N, hd) and in its multi-head form over (B*area, N, C), and
the plain PyTorch version of each. The per-layer prefix profiler of that
module is not ported yet.

    python -m yolou_tpu_torch.tools.profile_layers --attn --batch 128

Runs on the GPU (CUDA events) unless `--device cpu` is given (host clock).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..kernels.attention import (area_attention, area_attention_fused,
                                 area_attention_fused_plain,
                                 area_attention_plain)
from ..models.yolo import resolve_device

HEADS, TOKENS, HEAD_DIM, AREA = 4, 400, 32, 4


def call_ms(fn: Callable, device: torch.device, iters: int = 20,
            warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn`, after `warmup` calls: CUDA events
    around `iters` back-to-back calls on a GPU, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn: Callable, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of `fn` on the GPU: the kernel and
    copy time `torch.profiler` records over `iters` calls after `warmup`,
    without the host's time or the gaps between launches. Where `call_ms`
    reads more, the host, not the card, sets the pace of back-to-back
    calls."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(3):         # a trace that comes back empty is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
        if us > 0:
            return us / 1e3 / iters
    raise RuntimeError("torch.profiler recorded no device time")


def attention_shapes(batch: int) -> Tuple[Tuple[int, int, int],
                                          Tuple[int, int, int]]:
    """The (G, N, C) shapes the profiler gives the single-head and the
    multi-head entry point for `batch` images."""
    bands = batch * AREA
    return ((bands * HEADS, TOKENS, HEAD_DIM),
            (bands, TOKENS, HEADS * HEAD_DIM))


def profile_attention_variants(batch: int = 128,
                               device: torch.device | str | None = None,
                               iters: int = 20) -> Dict[str, Dict[str, float]]:
    """Time the four implementations on seeded bfloat16 inputs of `batch`
    images; per implementation the ms per call and the effective TFLOP/s of
    the attention's own 4 * G * N^2 * hd operations."""
    device = resolve_device(device)
    single, fused = attention_shapes(batch)
    rng = np.random.default_rng(0)

    def mk(shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(
            device, torch.bfloat16)

    q, k, v = (mk(single) for _ in range(3))
    qf, kf, vf = (mk(fused) for _ in range(3))
    flops = 4 * single[0] * TOKENS * TOKENS * HEAD_DIM
    impls = {
        "kernel_banded": lambda: area_attention(q, k, v),
        "kernel_fused": lambda: area_attention_fused(qf, kf, vf, HEADS),
        "plain_banded": lambda: area_attention_plain(q, k, v),
        "plain_fused": lambda: area_attention_fused_plain(qf, kf, vf, HEADS),
    }
    results = {}
    with torch.no_grad():
        for name, fn in impls.items():
            ms = call_ms(fn, device, iters=iters)
            results[name] = {"ms": ms, "tflops_effective": flops / ms / 1e9}
            print(f"{name:<14} {ms:8.3f} ms  {flops / ms / 1e9:6.2f} TFLOP/s "
                  f"eff", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--attn", action="store_true", required=True,
                    help="profile the attention implementations (the only "
                         "mode ported so far)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the GPU")
    args = ap.parse_args(argv)
    print(json.dumps(profile_attention_variants(args.batch, args.device)))


if __name__ == "__main__":
    main()
