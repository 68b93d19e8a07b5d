#!/usr/bin/env python3
"""Smoke run of the PyTorch port (yolou_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, one or more output lines each:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA;
  2. build   - nvcc builds the kernels from yolou_tpu_torch/csrc; the band
               attention and whole-A2C2f kernels' registers, spills and
               tensor-core (HMMA) instructions: bf16 must have them, f32
               (SIMT) must not;
  3. kernels - each CUDA kernel against its plain PyTorch version on the card,
               at the shapes the serving, training and evaluation paths give
               it, with times of the kernel, the plain version and, where one
               PyTorch call computes the same function, that call (for kernel
               A's attention part, scaled_dot_product_attention over the
               plain projection's q, k, v; the NMS kernel must be one
               device kernel a call): the card's own time from
               torch.profiler (`ms`) and CUDA events around back-to-back calls
               (`call_ms`, which counts the host where it sets the pace); the
               training attention's gradients against autograd through the
               plain version; the whole-A2C2f kernel also beside the staged
               A2C2f module on the same weights;
  4. serve   - a Predictor with seeded random yolov12n-seg weights (4 ch,
               nc=1, 640^2, bf16) answers 3 requests of 8 uint8 images; the
               kernels' launch counters must show the path went through them;
               then the same weights in f32 on the card and on the CPU must
               agree;
  5. train   - a DetectorTrainer on the card with the same weights (bf16,
               640^2, batch 8, mosaic on) takes 3 steps over a seeded
               in-memory batch: finite loss parts, 8 forward launches of the
               attention kernel and 8 calls of its backward per step,
               parameters, EMA and BatchNorm statistics moved, no step
               skipped; times per step and where they go; then one f32 step
               at batch 2 on the card and on the CPU must agree.
  6. profile - the attention profiler (`tools/profile_layers.py`, the one
               caller of the single-head attention entry point) at batch 8,
               at shapes phase 3 has checked; both attention entry points
               must have launched.
  7. serve-mega - the same weights with `build_yolo(mega_kernel=True)`: 3
               requests of 8; the whole-A2C2f kernel must launch twice a
               forward and the band attention kernel never; detections on
               every image; the batch-8 forward timed with the flag off and
               on; then f32 on the card, 2 images, flag on against flag off.
  8. evaluate - YOLO-Seg++ (`build_segpp`, bf16) with the same detector
               weights and a seeded decoder; an Evaluator at 160^2, batch 16,
               takes 3 batches of seeded images and elliptic masks from
               memory with HD95 on: 8 band attention launches and one NMS
               launch a step, 48 images, finite Dice, precision and recall in
               [0, 1]; images/s and the step's parts; then one f32 step on
               the card against the CPU.
  9. train-decoder - the YOLO-Seg++ training pipeline at 160^2, bf16, with
               the same detector weights: seeded images and elliptic masks
               in memory (512 train, 128 val, 128 test); objectmaps of every
               split from the port's generator at batch 128 (8 band
               attention launches a batch, no NMS); `DecoderTrainer.train()`
               over them, batch 128, 3 epochs (12 updates: finite history,
               the loss not up by more than 0.2, decoder moved, encoder
               bit-identical, best.pt / last.pt / history.csv written), then
               resumed from last.pt with 4 epochs (one more epoch, step 16);
               the step's time, parts, busy share and launches; an Evaluator
               on the test split with the trained decoder (8 band attention
               and one NMS launch a step); one f32 step card vs CPU; kernel
               A's gradient through an eval-mode AAttn against the plain
               version's, and the whole-A2C2f kernel's refusal of an input
               that requires grad.
Then a JSON line of kernel results (each kernel's launches on its path, error,
device and per-call times, and the least time the card could take), the
nvidia-smi line again,
and last {"ok": true, "device": {...}}. Any failure raises: exit code
non-zero and no "ok" line. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
IMGSZ = 640
BATCH = 8
REQUESTS = 3
TRAIN_STEPS = 3
EVAL_IMGSZ = 160
EVAL_BATCH = 16
EVAL_BATCHES = 3
DEC_SPLITS = {"train": 512, "val": 128, "test": 128}
DEC_BATCH = 128
DEC_EPOCHS = 3
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
BN_STD = 0.1
# published peaks of one H100 SXM, dense: bytes/s of HBM3, FLOP/s by input type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the current stream (CUDA events
    around `iters` back-to-back calls, after `warmup` calls): the attention
    profiler's timer, so that both read one clock the same way."""
    import torch
    from yolou_tpu_torch.tools.profile_layers import call_ms
    return call_ms(fn, torch.device("cuda"), iters, warmup)


def kernel_times(fn, iters: int = 20):
    """(device_ms, call_ms) per call of `fn`: the card's own time (kernel and
    copy time from torch.profiler, no host time and no gaps between
    launches), the time every kernel below is given as; and CUDA events
    around back-to-back calls, which also count the host wherever it, not
    the card, sets the pace (a kernel of a few microseconds behind a Python
    wrapper)."""
    from yolou_tpu_torch.tools.profile_layers import device_ms
    return device_ms(fn, iters), cuda_ms(fn, iters)


def device_kernels(fn, calls: int = 5) -> list:
    """The device kernels and copies torch.profiler records per call of
    `fn` (the names of `calls` calls, divided among them; raises if they do
    not divide evenly)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    if len(names) % calls:
        raise AssertionError(f"{len(names)} device events in {calls} calls")
    return names[:len(names) // calls]


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def f32_exact(torch) -> None:
    """Full-f32 matmuls and convolutions (no TF32) for exact comparisons."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- kernel A

def check_attention(device):
    """Kernel A against its plain version at the serving (640^2, batch 8),
    evaluation (160^2, batch 16) and objectmap (160^2, batch 128) shapes;
    times of the kernel, the plain version and, as a yardstick of the
    attention part alone (no one PyTorch call does projection + attention),
    scaled_dot_product_attention over the q, k, v that the plain projection
    gives."""
    import torch
    import torch.nn.functional as F
    from yolou_tpu_torch.kernels.attention import (
        area_attention_qkv_fused, area_attention_qkv_fused_plain)
    f32_exact(torch)
    # serving: 640^2, batch 8; evaluation: 160^2, batch 16; objectmaps:
    # 160^2, batch 128
    cases = [("L6@640", 4 * BATCH, 400, 64, 2), ("L8@640", BATCH, 400, 128, 4),
             ("L6@160", 4 * EVAL_BATCH, 25, 64, 2),
             ("L8@160", EVAL_BATCH, 25, 128, 4),
             ("L6@160b128", 4 * DEC_BATCH, 25, 64, 2),
             ("L8@160b128", DEC_BATCH, 25, 128, 4)]
    rng = np.random.default_rng(SEED)
    worst, times = 0.0, {}
    for name, g, n, c, heads in cases:
        x = rng.normal(size=(g, n, c)).astype(np.float32)
        w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c)).astype(np.float32)
        b = rng.normal(0, 0.1, (3 * c,)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            xt = torch.from_numpy(x).to(device, dtype)
            wt = torch.from_numpy(w).to(device, dtype)
            bt = torch.from_numpy(b).to(device)
            o, v = area_attention_qkv_fused(xt, wt, bt, heads)
            o_ref, v_ref = area_attention_qkv_fused_plain(xt, wt, bt, heads)
            err = max((o.float() - o_ref.float()).abs().max().item(),
                      (v.float() - v_ref.float()).abs().max().item())
            tol = ATTN_TOL[dtype_name(dtype)]
            finite = bool(torch.isfinite(o).all() and torch.isfinite(v).all())
            ms, call_ms = kernel_times(
                lambda: area_attention_qkv_fused(xt, wt, bt, heads))
            plain_ms, plain_call_ms = kernel_times(
                lambda: area_attention_qkv_fused_plain(xt, wt, bt, heads))
            qkv = (torch.matmul(xt.float(), wt.float()) + bt).to(dtype)
            qh, kh, vh = (t.reshape(g, n, heads, c // heads).transpose(1, 2)
                          for t in qkv.split(c, -1))
            attn_lib_ms, attn_lib_call_ms = kernel_times(
                lambda: F.scaled_dot_product_attention(qh, kh, vh))
            # x and w read, o and v written; projection + q.k^T + p.v
            nbytes = xt.element_size() * (3 * g * n * c + 3 * c * c) + 12 * c
            flops = 6 * g * n * c * c + 4 * g * n * n * c
            bound_ms, bound_by = bound(nbytes, flops, dtype_name(dtype))
            log("kernel", name="band_attention", case=name,
                shape=f"({g},{n},{c})h{heads}", dtype=dtype_name(dtype),
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                attention_library_ms=attn_lib_ms, bound_ms=bound_ms,
                bound_by=bound_by, call_ms=call_ms,
                plain_call_ms=plain_call_ms,
                attention_library_call_ms=attn_lib_call_ms)
            if not finite or not err <= tol:
                raise AssertionError(f"band attention {name} {dtype}: "
                                     f"max|d| {err} > {tol} or non-finite")
            worst = max(worst, err)
            times[(name, dtype)] = {"ms": ms, "call_ms": call_ms,
                                    "plain_ms": plain_ms,
                                    "bound_ms": bound_ms,
                                    "bound_by": bound_by, "library_ms": None,
                                    "attention_library_ms": attn_lib_ms}
    return dict(times[("L6@640", torch.bfloat16)], max_abs_err=worst)


# ------------------------------------------------------------- kernel C

def check_training_attention(device):
    """`area_attention_fused` (and `area_attention`, its one-head form)
    against the plain version: outputs and gradients at the two training
    shapes of yolov12n at 640^2 and batch 8, at the 160^2 band length, and
    at the two shapes the attention profiler gives them at that batch;
    times of kernel, plain version and the one PyTorch call that computes
    the function (scaled_dot_product_attention), a yardstick only."""
    import torch
    import torch.nn.functional as F
    from yolou_tpu_torch.kernels.attention import (
        area_attention, area_attention_fused, area_attention_fused_plain,
        area_attention_plain, attention_backward)
    from yolou_tpu_torch.tools.profile_layers import HEADS, attention_shapes
    f32_exact(torch)
    cases = [("L6@640", 4 * BATCH, 400, 64, 2), ("L8@640", BATCH, 400, 128, 4),
             ("L6@160", 4 * BATCH, 25, 64, 2), ("L8@160", BATCH, 25, 128, 4),
             ("single", 64, 400, 32, 1)]
    for name, shape, heads in zip(("profile-single", "profile-fused"),
                                  attention_shapes(BATCH), (1, HEADS)):
        cases.append((name, *shape, heads))
    rng = np.random.default_rng(SEED + 3)
    results = {}
    for name, g, n, c, heads in cases:
        single = heads == 1
        arrays = [rng.normal(size=(g, n, c)).astype(np.float32)
                  for _ in range(4)]
        kname = "band_attention_single" if single else "band_attention_train"
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do = (torch.from_numpy(a).to(device, dtype)
                           for a in arrays)
            if single:
                fn = lambda: area_attention(q, k, v)
                plain = lambda: area_attention_plain(q, k, v)
            else:
                fn = lambda: area_attention_fused(q, k, v, heads)
                plain = lambda: area_attention_fused_plain(q, k, v, heads)

            def sdpa():
                qh, kh, vh = (t.view(g, n, heads, c // heads).transpose(1, 2)
                              for t in (q, k, v))
                return F.scaled_dot_product_attention(qh, kh, vh)

            with torch.no_grad():
                o, ref = fn(), plain()
                lib = sdpa().transpose(1, 2).reshape(g, n, c)
            err = (o.float() - ref.float()).abs().max().item()
            lib_err = (lib.float() - ref.float()).abs().max().item()
            for t in (q, k, v):
                t.requires_grad_()
            grads = torch.autograd.grad(fn(), (q, k, v), do)
            want = torch.autograd.grad(plain(), (q, k, v), do)
            gerr = max((a.float() - b.float()).abs().max().item()
                       for a, b in zip(grads, want))
            for t in (q, k, v):
                t.requires_grad_(False)
            dn = dtype_name(dtype)
            with torch.no_grad():
                ms, call_ms = kernel_times(fn)
                plain_ms, plain_call_ms = kernel_times(plain)
                lib_ms, lib_call_ms = kernel_times(sdpa)
                bwd_ms = kernel_times(
                    lambda: attention_backward(q, k, v, do, heads))[0]
            nbytes = 4 * g * n * c * q.element_size()     # q, k, v in; o out
            bound_ms, bound_by = bound(nbytes, 4 * g * n * n * c, dn)
            log("kernel", name=kname, case=name,
                shape=f"({g},{n},{c})h{heads}", dtype=dn, max_abs_err=err,
                tol=ATTN_TOL[dn], grad_max_abs_err=gerr, grad_tol=GRAD_TOL[dn],
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_max_abs_err=lib_err, backward_ms=bwd_ms,
                bound_ms=bound_ms, bound_by=bound_by, call_ms=call_ms,
                plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms)
            if not (torch.isfinite(o).all() and err <= ATTN_TOL[dn]
                    and gerr <= GRAD_TOL[dn]):
                raise AssertionError(
                    f"{kname} {name} {dn}: max|d| {err} (tol {ATTN_TOL[dn]}),"
                    f" gradients {gerr} (tol {GRAD_TOL[dn]}) or non-finite")
            results[(name, dn)] = {
                "max_abs_err": err, "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "backward_ms": bwd_ms}
    worst = max(r["max_abs_err"] for (name, _), r in results.items()
                if not name.endswith("single"))
    return results, worst


# ------------------------------------------------- the whole-A2C2f kernel

def a2c2f_work(shape, c_, c2, n_stages, area, elt):
    """(bytes, operations) of one A2C2f block: x read, out written, each
    weight read once; the GEMMs, the per-head score and p.v products (width
    32 each, so 4 nb c_ a token) and the 49-tap stencil."""
    B, H, W, cin = shape
    tokens, nb = B * H * W, H * W // area
    per_block = 2 * c_ * (3 * c_ + c_ + 2 * c_ + 2 * c_)
    gemm = 2 * cin * c_ + 2 * n_stages * per_block + 2 * (n_stages + 1) * c_ * c2
    flops = tokens * (gemm + 2 * n_stages * (4 * nb * c_ + 2 * 49 * c_))
    weights = (cin * c_ + 2 * n_stages * per_block // 2
               + (n_stages + 1) * c_ * c2)
    small = 4 * (c_ + c2 + 2 * n_stages * (3 * c_ + 49 * c_ + c_ + c_ + 2 * c_ + c_))
    return elt * (tokens * (cin + c2) + weights) + small, flops


def seeded_a2c2f(c1: int, c2: int, n: int, area: int, device, seed: int):
    """A seeded A2C2f attention block in eval mode whose BatchNorms carry
    random statistics (so that folding them is not the identity) and a scale
    near 0.3, which keeps the block's activations of order 1."""
    import torch
    from torch import nn
    from yolou_tpu_torch.models.yolo import init_weights
    from yolou_tpu_torch.nn.attention import A2C2f
    gen = torch.Generator().manual_seed(seed)
    m = init_weights(A2C2f(c1, c2, n, a2=True, area=area), gen)
    with torch.no_grad():
        for bn in (b for b in m.modules() if isinstance(b, nn.BatchNorm2d)):
            shape = bn.weight.shape
            bn.weight.copy_(0.3 + 0.03 * torch.randn(shape, generator=gen))
            bn.bias.copy_(0.1 * torch.randn(shape, generator=gen))
            bn.running_mean.copy_(0.1 * torch.randn(shape, generator=gen))
            bn.running_var.copy_(0.5 + 0.5 * torch.rand(shape, generator=gen))
    return m.to(device).eval()


def check_a2c2f(device):
    """`a2c2f_fused` against its plain version at the two shapes the serving
    path gives it with `mega_kernel=True` (yolov12n layers 6 and 8 at 640^2,
    batch 8) and at a small shape with four bands, f32 and bf16; times of
    the kernel, of the plain version and of the staged `A2C2f.forward` on
    the same weights (about 80 launches with the band attention kernel
    inside: the route the kernel replaces, and the yardstick, since no one
    PyTorch call computes the block)."""
    import torch
    from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused, a2c2f_fused_plain
    f32_exact(torch)
    cases = [("L6@640", (BATCH, 40, 40, 128), 128, 2, 4),
             ("L8@640", (BATCH, 20, 20, 256), 256, 2, 1),
             ("small", (2, 16, 16, 64), 64, 1, 4)]
    rng = np.random.default_rng(SEED + 6)
    results = {}
    for i, (name, shape, c2, n, area) in enumerate(cases):
        module = seeded_a2c2f(shape[-1], c2, n, area, device, SEED + i)
        heads, c_ = module.num_heads, c2 // 2
        x = rng.normal(size=shape).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            dn = dtype_name(dtype)
            xt = torch.from_numpy(x).to(device, dtype)
            with torch.no_grad():
                ws = module.folded_weights(dtype)
                out = a2c2f_fused(xt, ws, n, area, heads)
                torch.cuda.synchronize()
                ref = a2c2f_fused_plain(xt, ws, n, area, heads)
                x_nchw = xt.permute(0, 3, 1, 2).contiguous()
                staged = module(x_nchw).permute(0, 2, 3, 1)
                err = (out.float() - ref.float()).abs().max().item()
                staged_err = (out.float() - staged.float()).abs().max().item()
                ms, call_ms = kernel_times(
                    lambda: a2c2f_fused(xt, ws, n, area, heads))
                plain_ms, plain_call_ms = kernel_times(
                    lambda: a2c2f_fused_plain(xt, ws, n, area, heads))
                staged_ms, staged_call_ms = kernel_times(
                    lambda: module(x_nchw))
            nbytes, flops = a2c2f_work(shape, c_, c2, n, area,
                                       xt.element_size())
            bound_ms, bound_by = bound(nbytes, flops, dn)
            # bf16: ATTN_TOL's absolute bound says little of outputs under
            # 1, so the error is also held to 2**-6 of the largest output (a
            # few bf16 steps there); the staged module rounds at other
            # points, so it gets twice the kernel's tolerance
            out_max = ref.abs().max().item()
            tol = ATTN_TOL[dn]
            if dtype == torch.bfloat16:
                tol = min(tol, 2.0 ** -6 * out_max)
            staged_tol = tol if dtype == torch.float32 else 2 * tol
            log("kernel", name="a2c2f", case=name,
                shape=f"{shape}c_{c_}n{n}a{area}h{heads}", dtype=dn,
                max_abs_err=err, tol=tol, out_abs_max=out_max,
                vs_staged_max_abs=staged_err, staged_tol=staged_tol, ms=ms,
                plain_ms=plain_ms, staged_ms=staged_ms, bound_ms=bound_ms,
                bound_by=bound_by, gflop=flops / 1e9, call_ms=call_ms,
                plain_call_ms=plain_call_ms, staged_call_ms=staged_call_ms)
            if not (torch.isfinite(out).all() and err <= tol):
                raise AssertionError(f"a2c2f {name} {dn}: max|d| {err} > "
                                     f"{tol} or non-finite")
            if not staged_err <= staged_tol:
                raise AssertionError(f"a2c2f {name} {dn}: kernel vs the "
                                     f"staged module {staged_err} > "
                                     f"{staged_tol}")
            results[(name, dn)] = {
                "max_abs_err": err, "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "staged_ms": staged_ms,
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    worst = max(r["max_abs_err"] for r in results.values())
    return dict(results[("L6@640", "bfloat16")], max_abs_err=worst)


# ------------------------------------------------------------- kernel B

def _nms_cases(rng, bsz, k):
    xy = rng.random((bsz, k, 2), np.float32) * 600
    wh = rng.random((bsz, k, 2), np.float32) * 120 + 8
    yield "random", np.concatenate([xy, xy + wh], -1)
    xy = rng.random((bsz, k, 2), np.float32) * 40 + 300
    wh = rng.random((bsz, k, 2), np.float32) * 60 + 20
    yield "dense", np.concatenate([xy, xy + wh], -1)


def check_nms(device):
    import torch
    from yolou_tpu_torch.kernels.nms import suppress_greedy, suppress_greedy_plain
    from yolou_tpu_torch.ops.nms import non_max_suppression
    rng = np.random.default_rng(SEED + 1)
    bsz, k = 16, 512
    worst = 0.0
    for name, boxes in _nms_cases(rng, bsz, k):
        bt = torch.from_numpy(boxes.astype(np.float32)).to(device)
        vt = torch.from_numpy(rng.random((bsz, k)) < 0.9).to(device)
        keep = suppress_greedy(bt, vt, 0.45)
        ref = suppress_greedy_plain(bt, vt, 0.45)
        err = (keep.float() - ref.float()).abs().max().item()
        log("kernel", name="greedy_nms", case=name, shape=f"({bsz},{k})",
            kept=int(keep.sum()), mismatches=int((keep != ref).sum()),
            ms=cuda_ms(lambda: suppress_greedy(bt, vt, 0.45)),
            plain_ms=cuda_ms(lambda: suppress_greedy_plain(bt, vt, 0.45)))
        if not torch.equal(keep, ref):
            raise AssertionError(f"greedy NMS {name}: keep-sets differ")
        worst = max(worst, err)
    # equal scores: the whole NMS on the card and on the CPU, same preds
    n = 2 * k
    xy = rng.random((bsz, n, 2), np.float32) * 600
    wh = rng.random((bsz, n, 2), np.float32) * 100 + 10
    score = rng.choice(np.float32([0.3, 0.6, 0.9]), (bsz, n, 1))
    pred = torch.from_numpy(np.concatenate([xy, wh, score], -1)
                            .astype(np.float32))
    got = non_max_suppression(pred.to(device), nc=1, top_k=k)
    want = non_max_suppression(pred, nc=1, top_k=k)
    same = all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    log("kernel", name="greedy_nms", case="equal-scores", shape=f"({bsz},{k})",
        kept=int(got.valid.sum()), identical_to_cpu=same)
    if not same:
        raise AssertionError("greedy NMS equal-scores: card != CPU")
    # time at the serving shape: B = 8 images, K = 512 candidates
    bt = torch.from_numpy(boxes[:BATCH].astype(np.float32)).to(device)
    vt = torch.ones((BATCH, k), dtype=torch.bool, device=device)
    per_call = device_kernels(lambda: suppress_greedy(bt, vt, 0.45))
    log("kernel", name="greedy_nms", check="device kernels per call",
        kernels=per_call)
    if len(per_call) != 1:
        raise AssertionError(f"greedy NMS launched {per_call} a call, want "
                             f"one kernel")
    ms, call_ms = kernel_times(lambda: suppress_greedy(bt, vt, 0.45))
    plain_ms, plain_call_ms = kernel_times(
        lambda: suppress_greedy_plain(bt, vt, 0.45))
    # boxes and valid read, keep written; the work depends on the data: each
    # kept box is tested against every later candidate, 16 f32 operations an
    # IoU test
    keep = suppress_greedy(bt, vt, 0.45)
    later = (k - 1 - torch.arange(k, device=device)).expand(BATCH, k)
    tests = int(later[keep].sum())
    bound_ms, bound_by = bound(bt.numel() * 4 + 2 * vt.numel(), 16 * tests,
                               "float32")
    log("kernel", name="greedy_nms", case="serve", shape=f"({BATCH},{k})",
        kept=int(keep.sum()), iou_tests=tests, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, call_ms=call_ms,
        plain_call_ms=plain_call_ms)
    return {"max_abs_err": worst, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# ------------------------------------------------------------- serving

def make_labelled(rng, count: int, hw: int = IMGSZ, max_inst: int = 16):
    """Bright ellipses on dark noise with their labels, in the form
    `collate_idmap_cached` gives a trainer: img uint8 (count, hw, hw, 4),
    idmap uint8 (count, hw, hw) with ellipse j of an image drawn as j + 1
    (later ones on top), cls int32 and valid bool (count, max_inst)."""
    imgs = rng.normal(40, 12, (count, hw, hw, 4)).clip(0, 255)
    idmap = np.zeros((count, hw, hw), np.uint8)
    cls = np.zeros((count, max_inst), np.int32)
    valid = np.zeros((count, max_inst), bool)
    yy, xx = np.mgrid[:hw, :hw]
    for i in range(count):
        for j in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0.2 * hw, 0.8 * hw, 2)
            ry, rx = rng.uniform(0.04 * hw, 0.15 * hw, 2)
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            imgs[i][inside] = rng.uniform(180, 255, 4)
            idmap[i][inside] = j + 1
        ids = np.unique(idmap[i])
        valid[i, ids[ids > 0] - 1] = True     # an ellipse may be covered
    return imgs.astype(np.uint8), idmap, cls, valid


def make_images(rng, count: int, hw: int = IMGSZ) -> np.ndarray:
    """Bright ellipses on dark noise, uint8 (count, hw, hw, 4)."""
    return make_labelled(rng, count, hw)[0]


def seeded_state_dict():
    """yolov12n-seg (4 ch, nc=1) weights from SEED: seeded random convs;
    every BatchNorm calibrated by one f32 CPU pass over a seeded batch to
    output mean 0 and std BN_STD (its running statistics set to its batch's,
    its weight to BN_STD); then the warm-started head bias, so scores clear
    the confidence gate. Without the calibration the activations of a random
    init vanish within a few layers (empty masks); at std 1 the random
    network is chaotic (a 1e-6 input change moves boxes by pixels on the
    CPU), so no two devices could agree. At std 0.1 the same change moves
    boxes by < 1e-3 px and every image still gets detections with masks."""
    import torch
    from torch import nn
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.nn.heads import warm_start_detect_bias
    from yolou_tpu_torch.ops.letterbox import letterbox_batch
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu", seed=SEED)
    calib = make_images(np.random.default_rng(SEED + 2), 2)
    x = letterbox_batch(torch.from_numpy(calib), (IMGSZ, IMGSZ))
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.fill_(BN_STD)
            bn.train()
            bn.momentum = 1.0
        model(x.permute(0, 3, 1, 2))
    for bn in bns:
        bn.eval()
        bn.momentum = 0.03
    return warm_start_detect_bias(model).state_dict()


def build_model(state_dict, device, dtype, mega_kernel=False):
    from yolou_tpu_torch.models.yolo import build_yolo
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       dtype=dtype, device=device, mega_kernel=mega_kernel)
    model.load_state_dict(state_dict, strict=True)
    return model


def serve(state_dict, device, dtype, requests, mega_kernel=False):
    """Drive the Predictor over `requests` (list of uint8 stacks); returns
    per-request detections and times."""
    import torch
    from yolou_tpu_torch.engine.predictor import Predictor
    predictor = Predictor(build_model(state_dict, device, dtype, mega_kernel),
                          imgsz=IMGSZ, batch_size=BATCH)
    stats = []
    for r, imgs in enumerate(requests):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        results = predictor(imgs)
        end.record()
        end.synchronize()
        dev_ms = start.elapsed_time(end)
        host_ms = (time.perf_counter() - t0) * 1e3
        dets = [len(res) for res in results]
        for res, img in zip(results, imgs):
            if not np.isfinite(res.boxes.data).all():
                raise AssertionError(f"request {r}: non-finite boxes")
            m = res.masks.data
            if m.shape != (len(res),) + img.shape[:2]:
                raise AssertionError(f"request {r}: masks {m.shape}")
        stats.append({"request": r, "images": len(imgs),
                      "detections": dets, "event_ms": dev_ms,
                      "host_ms": host_ms})
        del results
    return stats


def kept_anchors(preds, dets):
    """Per image, the anchor indices of the kept detections (their boxes are
    exact copies of xywh2xyxy(preds[..., :4]) rows)."""
    import torch
    from yolou_tpu_torch.ops.boxes import xywh2xyxy
    allb = xywh2xyxy(preds[..., :4])
    out = []
    for b in range(preds.shape[0]):
        n = int(dets.valid[b].sum())
        eq = (dets.boxes[b, :n, None, :] == allb[b, None]).all(-1)
        if not bool(eq.any(1).all()):
            raise AssertionError("kept box not found among the anchors")
        out.append(set(eq.int().argmax(1).tolist()))
    return out


def compare_f32(state_dict, device, imgs):
    """Same weights and images in f32 on the card (no TF32) and on the CPU
    (plain kernel versions): preds within 1e-3, and the kept anchors equal
    except where a candidate's score is within 1e-4 of another's."""
    import torch
    from yolou_tpu_torch.engine.predictor import Predictor
    from yolou_tpu_torch.ops.nms import (NMSResult, non_max_suppression,
                                         topk_stable)
    f32_exact(torch)
    outs = {}
    for dev in (device, "cpu"):
        p = Predictor(build_model(state_dict, dev, torch.float32),
                      imgsz=IMGSZ)
        dets, out = p.infer(torch.from_numpy(imgs).to(dev))
        outs[dev] = (out.preds.cpu(), [t.cpu() for t in dets])
    (pg, dg), (pc, dc) = outs[device], outs["cpu"]
    err = (pg - pc).abs().max().item()
    dg, dc = NMSResult(*dg), NMSResult(*dc)
    kg, kc = kept_anchors(pg, dg), kept_anchors(pc, dc)
    score = pc[..., 4]
    clear_bad = tied_bad = agree = 0
    for b in range(pc.shape[0]):
        s_k, idx = topk_stable(torch.where(score[b] > 0.25, score[b], -1.0), 512)
        gap = (s_k[:-1] - s_k[1:]).abs()
        tied = torch.zeros_like(s_k, dtype=torch.bool)
        tied[:-1] |= gap <= 1e-4
        tied[1:] |= gap <= 1e-4
        tied_set = set(idx[tied].tolist())
        for a in kg[b] ^ kc[b]:
            if a in tied_set:
                tied_bad += 1
            else:
                clear_bad += 1
        agree += len(kg[b] & kc[b])
    # NMS alone on identical input: the card's kernel vs the CPU plain version
    same_in = non_max_suppression(pc.to(device), nc=1)
    ident = all(torch.equal(a.cpu(), b_) for a, b_ in
                zip(same_in, non_max_suppression(pc, nc=1)))
    log("serve", check="f32 card vs cpu", images=len(imgs), preds_max_abs=err,
        tol=1e-3, kept_agree=agree, differ_clear=clear_bad,
        differ_near_tie=tied_bad, nms_same_input_identical=ident)
    if not err <= 1e-3:
        raise AssertionError(f"f32 preds card vs cpu: {err} > 1e-3")
    if clear_bad or not ident:
        raise AssertionError("f32 kept-box sets differ between card and cpu")
    return err


def compare_mega(state_dict, device, requests):
    """`mega_kernel=True` against the staged model on the same weights: the
    batch-8 bf16 forward timed in turns (staged, mega, mega, staged; CUDA
    events and a profiler window each), then f32 on the card, 2 images:
    preds within the tolerance `compare_f32` uses."""
    import torch
    from yolou_tpu_torch.ops.letterbox import letterbox_batch
    f32_exact(torch)
    imgs = torch.from_numpy(requests[0]).to(device)
    x = letterbox_batch(imgs, (IMGSZ, IMGSZ)).permute(0, 3, 1, 2).contiguous()
    models = {mega: build_model(state_dict, device, torch.bfloat16, mega)
              for mega in (False, True)}
    times = {False: [], True: []}
    with torch.no_grad():
        for mega in (False, True, True, False):
            times[mega].append(cuda_ms(lambda: models[mega](x), iters=10))
        prof = {mega: profile_step(lambda: models[mega](x))
                for mega in (False, True)}
        f32 = {mega: build_model(state_dict, device, torch.float32, mega)(
            x[:2].float()).preds for mega in (False, True)}
    err = (f32[True] - f32[False]).abs().max().item()
    log("serve-mega", check="forward, batch 8, bf16",
        staged_ms=times[False], mega_ms=times[True],
        staged_device_ms=prof[False][0], staged_launches=prof[False][1],
        mega_device_ms=prof[True][0], mega_launches=prof[True][1])
    log("serve-mega", check="f32 mega vs staged", images=2,
        preds_max_abs=err, tol=1e-3)
    if not err <= 1e-3:
        raise AssertionError(f"f32 preds mega vs staged: {err} > 1e-3")


# ------------------------------------------------------------- evaluation

def make_eval_batches(rng, batches, batch, hw):
    """`batches` tuples (imgs f32 in [0, 1] (batch, hw, hw, 4), masks f32 in
    {0, 1} (batch, hw, hw, 1), None, batch), as `DecoderDataset.batches`
    yields them: bright ellipses on dark noise and their union as the mask."""
    imgs, idmap, _, _ = make_labelled(rng, batches * batch, hw)
    imgs = imgs.astype(np.float32) / 255.0
    masks = (idmap > 0).astype(np.float32)[..., None]
    return [(imgs[i:i + batch], masks[i:i + batch], None, batch)
            for i in range(0, batches * batch, batch)]


def segpp_state_dict(state_dict, calib):
    """YOLO-Seg++ weights at full width: the detector's from `state_dict`, a
    decoder seeded from SEED with its BatchNorms calibrated like the
    detector's (see `seeded_state_dict`) and its output bias centred on the
    batch `calib`, all in f32 on the CPU, so that every device gets the same
    weights and the masks are neither empty nor full."""
    import torch
    from torch import nn
    from yolou_tpu_torch.models.segpp import build_segpp
    ref = build_segpp("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu", seed=SEED)
    ref.yolo.load_state_dict(state_dict, strict=True)
    x = torch.from_numpy(calib).permute(0, 3, 1, 2)
    bns = [m for m in ref.decoder.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.fill_(1.0)
            bn.momentum = 1.0
        ref.train()(x)
        for bn in bns:
            bn.momentum = 0.03
        ref.output.bias -= ref.eval()(x)[0].median()
    return ref.state_dict()


def build_evaluator(segpp_sd, device, dtype):
    """An Evaluator at 160^2, batch 16; `device` None is its default, the
    card."""
    from yolou_tpu_torch.engine.evaluator import Evaluator
    from yolou_tpu_torch.models.segpp import build_segpp
    model = build_segpp("yolov12", "n", nc=1, ch=4, task="segment",
                        dtype=dtype, device=device)
    model.load_state_dict(segpp_sd, strict=True)
    return Evaluator(model, data_root="", image_size=EVAL_IMGSZ,
                     batch_size=EVAL_BATCH, device=device)


def evaluate_breakdown(ev, batch, iters: int = 5):
    """The parts of one evaluation step, CUDA events between them (each
    waits for the part before it), means over `iters` steps after one."""
    import torch
    from yolou_tpu_torch.metrics.seg import (dice_binary, hd95_batch,
                                             precision_recall_counts)
    from yolou_tpu_torch.ops.nms import non_max_suppression
    imgs, masks = batch[0], batch[1]
    names = ("upload", "forward", "nms", "threshold", "dice_pr", "hd95")
    sums = dict.fromkeys(names, 0.0)
    for i in range(iters + 1):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        with torch.no_grad():
            e[0].record()
            x = torch.as_tensor(imgs).to(ev.device)
            m = torch.as_tensor(masks).to(ev.device)[..., 0]
            e[1].record()
            mask_logits, out = ev.model(x.permute(0, 3, 1, 2))
            e[2].record()
            non_max_suppression(out.preds, conf_thres=ev.conf,
                                iou_thres=ev.iou, max_det=ev.max_det,
                                nc=ev.model.spec.nc)
            e[3].record()
            pred = (torch.sigmoid(mask_logits) > 0.5).float()[:, 0]
            e[4].record()
            dice_binary(pred, m)
            precision_recall_counts(pred, m)
            e[5].record()
            hd95_batch(pred, m)
            e[6].record()
        e[6].synchronize()
        if i:
            for name, a, b in zip(names, e, e[1:]):
                sums[name] += a.elapsed_time(b) / iters
    return {f"{k}_ms": v for k, v in sums.items()}


def evaluate(state_dict, device):
    """The evaluation path on the card, bf16, then one f32 step card vs CPU."""
    import torch
    from yolou_tpu_torch import kernels
    f32_exact(torch)
    batches = make_eval_batches(np.random.default_rng(SEED + 7), EVAL_BATCHES,
                                EVAL_BATCH, EVAL_IMGSZ)
    segpp_sd = segpp_state_dict(state_dict, batches[0][0])
    ev = build_evaluator(segpp_sd, None, torch.bfloat16)
    if ev.device.type != "cuda":
        raise AssertionError(f"the evaluator chose {ev.device}, not the card")
    ev.accumulate(iter(batches[:1]))                # cuDNN set-up
    kernels.reset_launch_counts()
    res = ev.accumulate(iter(batches), with_hd95=True)
    counts = kernels.launch_counts()
    log("evaluate", **res, launches=counts, steps=len(batches))
    want = {"band_attention": 8 * len(batches), "greedy_nms": len(batches)}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"evaluation launched {counts}, want {want}")
    if res["n_images"] != EVAL_BATCHES * EVAL_BATCH:
        raise AssertionError(f"evaluated {res['n_images']} images")
    if not all(np.isfinite(res[k]) and 0.0 <= res[k] <= 1.0
               for k in ("dice", "precision", "recall")):
        raise AssertionError(f"metrics out of range: {res}")
    parts = evaluate_breakdown(ev, batches[0])
    step_ms = cuda_ms(lambda: ev.accumulate(iter(batches[:1])), iters=5,
                      warmup=1)
    busy_ms, launches, top = profile_step(
        lambda: ev.accumulate(iter(batches[:1])))
    log("evaluate", batch=EVAL_BATCH, imgsz=EVAL_IMGSZ, step_ms=step_ms,
        images_per_s=EVAL_BATCH / step_ms * 1e3, **parts,
        device_busy_ms=busy_ms,
        device_busy_share=busy_ms / step_ms if busy_ms else None,
        device_launches=launches, top_device_kernels=top)
    # one f32 step, card against CPU, same weights and batch
    imgs = batches[1][0]
    got = {}
    for dev in (device, "cpu"):
        e32 = build_evaluator(segpp_sd, dev, torch.float32)
        with torch.no_grad():
            x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2)
            got[str(dev)] = (e32.model(x)[0].cpu(), e32.step(imgs)[0].cpu())
    (lg, bg), (lc, bc) = got[str(device)], got["cpu"]
    err = (lg - lc).abs().max().item()
    flipped = (bg != bc).float().mean().item()
    log("evaluate", check="f32 card vs cpu", images=len(imgs),
        mask_logits_max_abs=err, tol=1e-3, flipped_pixel_share=flipped,
        flipped_tol=1e-3, mask_share=bc.mean().item())
    if not (err <= 1e-3 and flipped <= 1e-3):
        raise AssertionError(f"f32 evaluation step card vs cpu: mask logits "
                             f"{err}, flipped pixels {flipped}")
    return counts


# ------------------------------------------------------- decoder training

def make_decoder_split(rng, count: int, hw: int = EVAL_IMGSZ):
    """uint8 images (count, hw, hw, 4) and masks (count, hw, hw, 1) in {0,
    255}: bright ellipses on dark noise and their union."""
    imgs, idmap, _, _ = make_labelled(rng, count, hw)
    return imgs, ((idmap > 0) * 255).astype(np.uint8)[..., None]


def memory_dataset(imgs, masks, objectmaps):
    """A `DecoderDataset` over arrays in memory (no files, no cv2): its own
    `batches` (wrap-filled tail, shuffling, uint8 or [0, 1] floats) over
    these items, the objectmaps conditioned as the dataset conditions the
    files it reads (z-score, then sigmoid)."""
    from yolou_tpu_torch.data.decoder_dataset import (DecoderDataset,
                                                      condition_objectmap)

    class MemoryDataset(DecoderDataset):
        def __init__(self):
            self.oms = [condition_objectmap(m) for m in objectmaps]

        def __len__(self):
            return len(imgs)

        def item_u8(self, i):
            return imgs[i], masks[i], self.oms[i]

    return MemoryDataset()


def objectmap_phase(state_dict, device, splits):
    """Objectmaps of every split from the port's generator (Predictor at
    160^2, bf16, batch 128): one warm-up batch, then every split timed;
    8 band attention launches a batch and no NMS."""
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.engine.generate import objectmaps_from_images
    from yolou_tpu_torch.engine.predictor import Predictor
    predictor = Predictor(build_model(state_dict, device, torch.bfloat16),
                          imgsz=EVAL_IMGSZ, batch_size=DEC_BATCH)
    objectmaps_from_images(predictor, splits["train"][0][:DEC_BATCH])
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    maps = {name: np.concatenate([
        objectmaps_from_images(predictor, imgs[i:i + DEC_BATCH])
        for i in range(0, len(imgs), DEC_BATCH)])
        for name, (imgs, _) in splits.items()}
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    n = sum(len(imgs) for imgs, _ in splits.values())
    batches = sum(-(-len(imgs) // DEC_BATCH) for imgs, _ in splits.values())
    side = EVAL_IMGSZ // 8
    log("train-decoder", check="objectmaps", images=n, batches=batches,
        seconds=seconds, images_per_s=n / seconds, launches=counts,
        logit_mean=float(np.mean(maps["train"])),
        logit_std=float(np.std(maps["train"])))
    if counts["band_attention"] != 8 * batches or counts["greedy_nms"]:
        raise AssertionError(f"objectmaps launched {counts}, want "
                             f"{8 * batches} band attention and no NMS")
    for name, m in maps.items():
        if (m.shape != (len(splits[name][0]), side, side)
                or not np.isfinite(m).all() or m.std() == 0):
            raise AssertionError(f"objectmaps of {name}: {m.shape}, "
                                 f"finite {np.isfinite(m).all()}")
    return maps, counts


def decoder_trainer(segpp_sd, device, dtype, datasets, run_dir, **cfg):
    """A DecoderTrainer over YOLO-Seg++ with `segpp_sd`, its datasets the
    in-memory `datasets` (train, val); `device` None is its default, the
    card."""
    from yolou_tpu_torch.engine.trainer_decoder import (DecoderTrainConfig,
                                                        DecoderTrainer)
    from yolou_tpu_torch.models.segpp import build_segpp
    model = build_segpp("yolov12", "n", nc=1, ch=4, task="segment",
                        dtype=dtype, device=device or "cpu")
    model.load_state_dict(segpp_sd, strict=True)
    cfg = DecoderTrainConfig(**dict(
        dict(image_size=EVAL_IMGSZ, batch_size=DEC_BATCH, lr=1e-4,
             epochs=DEC_EPOCHS, early_stopping=False, run_dir=run_dir),
        **cfg))
    tr = DecoderTrainer(model, data_root="", cfg=cfg, device=device)
    tr._loaders = lambda: datasets
    return tr


def decoder_step_times(tr, batch, iters: int = 5):
    """The step by CUDA events (mean of `iters` after one), its parts with
    events between them (upload, forward, loss, backward, optimizer), and a
    profiler window: busy ms, launches, largest kernels."""
    import torch
    from yolou_tpu_torch.losses.dice import soft_dice_loss
    step_ms = cuda_ms(lambda: tr.step(*batch), iters=iters, warmup=1)
    names = ("upload", "forward", "loss", "backward", "optimizer")
    sums = dict.fromkeys(names, 0.0)
    for i in range(iters + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        ev[0].record()
        img, mask, om = tr._upload(*batch)
        ev[1].record()
        tr.model.train()
        pred, _ = tr.model(img, logits=om)
        ev[2].record()
        loss = soft_dice_loss(pred, mask)
        ev[3].record()
        tr.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[4].record()
        tr.optimizer.step()
        tr.scheduler.step()
        tr.step_count += 1
        ev[5].record()
        ev[5].synchronize()
        if i:
            for name, a, b in zip(names, ev, ev[1:]):
                sums[name] += a.elapsed_time(b) / iters
    busy_ms, launches, top = profile_step(lambda: tr.step(*batch))
    return {"step_ms": step_ms, **{f"{k}_ms": v for k, v in sums.items()},
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / step_ms if busy_ms else None,
            "device_launches": launches, "top_device_kernels": top}


def compare_decoder_f32(segpp_sd, device, datasets, run_dir):
    """One f32 decoder step, batch 2, same weights and batch, on the card
    (no TF32) and on the CPU: loss within 1e-5 relative; decoder parameters
    and running statistics every element within half an update (5e-5 at lr
    1e-4) and all but 0.5 % within 1e-6. AdamW's first update moves an
    element by lr g / (|g| + 1e-8), about lr whatever the gradient's size,
    so where a gradient is a cancelling sum at f32 noise, within a few
    1e-9 of 0, its sign (and a share of lr) differs between two
    summation orders."""
    import torch
    f32_exact(torch)
    imgs, masks, oms, _ = next(datasets[0].batches(2, u8=True))
    got = {}
    for dev in (device, "cpu"):
        tr = decoder_trainer(segpp_sd, dev, torch.float32, datasets, run_dir,
                             batch_size=2)
        tr.ensure_ready(1)
        loss, _ = tr.step(imgs, masks, oms)
        got[str(dev)] = (loss.item(), {
            k: v.cpu() for k, v in tr.model.state_dict().items()
            if not k.startswith("yolo.") and v.is_floating_point()})
    (lg, sg), (lc, sc) = got[str(device)], got["cpu"]
    d = torch.cat([(sg[k] - sc[k]).abs().flatten() for k in sc])
    rel = abs(lg - lc) / abs(lc)
    log("train-decoder", check="f32 card vs cpu", batch=2, loss_card=lg,
        loss_cpu=lc, loss_rel=rel, loss_tol=1e-5,
        decoder_max_abs=d.max().item(), decoder_max_tol=5e-5,
        share_past_1e_6=(d > 1e-6).float().mean().item(), share_tol=5e-3)
    if not (rel <= 1e-5 and d.max().item() <= 5e-5
            and (d > 1e-6).float().mean().item() <= 5e-3):
        raise AssertionError("f32 decoder step card vs cpu out of tolerance")


def check_attention_gradients(device):
    """Kernel A is differentiable on the card: an eval-mode AAttn at the
    evaluation shapes (layers 6 and 8 of yolov12n at 160^2, batch 16), its
    input requiring grad; the input and parameter gradients against
    autograd through the same module with the plain version in the kernel's
    place. f32 within 1e-4; bf16 within 2^-6 of each tensor's largest
    gradient (the kernel's forward, one bf16 step from the plain one's,
    feeds the projection whose weight gradient sums it over the tokens).
    Then the whole-A2C2f kernel, which has no backward, must refuse an input
    that requires grad, by name."""
    import torch
    from unittest import mock
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused
    from yolou_tpu_torch.kernels.attention import \
        area_attention_qkv_fused_plain
    from yolou_tpu_torch.nn import attention as nn_attention
    f32_exact(torch)
    rng = np.random.default_rng(SEED + 9)
    results, calls = {}, 0
    for name, dim, heads, area, hw in (("L6@160", 64, 2, 4, 10),
                                       ("L8@160", 128, 4, 1, 5)):
        block = seeded_a2c2f(dim, dim * 2, 1, area, device, SEED + dim)
        module = block.m[0][0].attn
        x = rng.normal(size=(EVAL_BATCH, dim, hw, hw))
        for dtype in (torch.float32, torch.bfloat16):
            dn = dtype_name(dtype)
            xt = torch.tensor(x, dtype=dtype, device=device,
                              requires_grad=True)
            dy = torch.tensor(rng.normal(size=x.shape), dtype=dtype,
                              device=device)
            wrt = [xt, *module.parameters()]
            kernels.reset_launch_counts()
            got = torch.autograd.grad(module(xt), wrt, dy)
            launched = kernels.launch_counts()["band_attention"]
            backward = kernels.backward_counts()["band_attention"]
            calls += backward
            with mock.patch.object(nn_attention, "area_attention_qkv_fused",
                                   area_attention_qkv_fused_plain):
                want = torch.autograd.grad(module(xt), wrt, dy)
            errs = [(a.float() - b.float()).abs().max().item()
                    / (1.0 if dtype == torch.float32
                       else b.float().abs().max().item())
                    for a, b in zip(got, want)]
            tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
            log("train-decoder", check="kernel A gradient", case=name,
                shape=f"({EVAL_BATCH * area},{hw * hw // area},{dim})h{heads}",
                dtype=dn, launches=launched, backward_calls=backward,
                input_err=errs[0], max_param_err=max(errs[1:]), tol=tol,
                relative=dtype != torch.float32)
            if launched != 1 or backward != 1:
                raise AssertionError(f"kernel A {name} {dn}: {launched} "
                                     f"launches, {backward} backward calls")
            if not all(np.isfinite(errs)) or max(errs) > tol:
                raise AssertionError(f"kernel A gradient {name} {dn}: "
                                     f"{errs} > {tol}")
            results[(name, dn)] = max(errs)
    block = seeded_a2c2f(64, 64, 1, 4, device, SEED)
    x = torch.zeros((2, 16, 16, 64), device=device, requires_grad=True)
    try:
        a2c2f_fused(x, block.folded_weights(torch.float32), 1, 4,
                    block.num_heads)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("a2c2f_fused ran on an input requiring grad")
    log("train-decoder", check="a2c2f refuses grad", message=message)
    if "a2c2f_fused is not differentiable" not in message:
        raise AssertionError(f"a2c2f_fused refused with {message!r}")
    return results, calls


def train_decoder_phase(state_dict, device):
    """The YOLO-Seg++ training pipeline on the card: objectmaps from the
    port's generator, the decoder trainer over them (3 epochs, then resumed
    for a fourth), the trained model evaluated; one f32 step card vs CPU;
    kernel A's gradient. Returns the launches of each path and kernel A's
    backward calls."""
    import os
    import tempfile
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.engine.evaluator import Evaluator
    rng = np.random.default_rng(SEED + 8)
    splits = {name: make_decoder_split(rng, n)
              for name, n in DEC_SPLITS.items()}
    maps, map_counts = objectmap_phase(state_dict, device, splits)
    data = {name: memory_dataset(*splits[name], maps[name])
            for name in splits}
    datasets = (data["train"], data["val"])
    calib = splits["train"][0][:4].astype(np.float32) / 255.0
    segpp_sd = segpp_state_dict(state_dict, calib)

    with tempfile.TemporaryDirectory() as run_dir:
        tr = decoder_trainer(segpp_sd, None, torch.bfloat16, datasets,
                             os.path.join(run_dir, "a"))
        if tr.device.type != "cuda":
            raise AssertionError(f"the trainer chose {tr.device}")
        before = {k: v.clone() for k, v in tr.model.state_dict().items()}
        kernels.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        history = tr.train()
        train_counts = kernels.launch_counts()
        after = tr.model.state_dict()
        steps = DEC_EPOCHS * DEC_SPLITS["train"] // DEC_BATCH
        # the encoder stops before layer 5: no attention, no kernel
        log("train-decoder", check="train", steps=tr.step_count,
            epoch_seconds=tr.epoch_times, launches=train_counts, **history)
        run = os.path.join(run_dir, "a", os.listdir(
            os.path.join(run_dir, "a"))[0])
        files = sorted(os.listdir(run)) + sorted(
            os.listdir(os.path.join(run, "weights")))
        encoder_same = all(torch.equal(after[k], before[k]) for k in after
                           if k.startswith("yolo."))
        moved = sum(not torch.equal(after[k], before[k]) for k in after
                    if not k.startswith("yolo.")
                    and after[k].is_floating_point())
        log("train-decoder", files=files, encoder_bit_identical=encoder_same,
            decoder_tensors_moved=moved)
        if tr.step_count != steps:
            raise AssertionError(f"{tr.step_count} updates, want {steps}")
        if not all(len(v) == DEC_EPOCHS and np.isfinite(v).all()
                   for v in history.values()):
            raise AssertionError(f"history not finite: {history}")
        if not history["train_loss"][2] <= history["train_loss"][0] + 0.2:
            raise AssertionError("the training loss went up")
        if not encoder_same or moved < 10:
            raise AssertionError("encoder changed or decoder did not move")
        if not {"best.pt", "last.pt", "history.csv"} <= set(files):
            raise AssertionError(f"the run wrote {files}")

        tr2 = decoder_trainer(segpp_sd, None, torch.bfloat16, datasets,
                              os.path.join(run_dir, "b"),
                              epochs=DEC_EPOCHS + 1)
        h2 = tr2.train(resume_from=os.path.join(run, "weights", "last.pt"))
        log("train-decoder", check="resume", epochs=len(h2["train_loss"]),
            steps=tr2.step_count, epoch_seconds=tr2.epoch_times, **h2)
        if len(h2["train_loss"]) != 1 or tr2.step_count != steps + 4:
            raise AssertionError(f"resume ran {len(h2['train_loss'])} "
                                 f"epochs to step {tr2.step_count}")
        batch = next(data["train"].batches(DEC_BATCH, u8=True))[:3]
        times = decoder_step_times(tr2, batch)
        log("train-decoder", batch=DEC_BATCH, imgsz=EVAL_IMGSZ, **times,
            peak_memory_mb=torch.cuda.max_memory_allocated() / 2 ** 20)

        ev = Evaluator(tr.model, data_root="", image_size=EVAL_IMGSZ,
                       batch_size=EVAL_BATCH)
        imgs, masks = splits["test"]
        test_batches = [(imgs[i:i + EVAL_BATCH].astype(np.float32) / 255.0,
                         masks[i:i + EVAL_BATCH].astype(np.float32) / 255.0,
                         None, EVAL_BATCH)
                        for i in range(0, len(imgs), EVAL_BATCH)]
        ev.accumulate(iter(test_batches[:1]))        # cuDNN set-up
        kernels.reset_launch_counts()
        res = ev.accumulate(iter(test_batches), with_hd95=True)
        eval_counts = kernels.launch_counts()
        log("train-decoder", check="evaluate trained", **res,
            launches=eval_counts, steps=len(test_batches))
        want = {"band_attention": 8 * len(test_batches),
                "greedy_nms": len(test_batches)}
        if any(eval_counts[k] != v for k, v in want.items()):
            raise AssertionError(f"evaluation launched {eval_counts}, "
                                 f"want {want}")
        if not np.isfinite(res["dice"]):
            raise AssertionError(f"evaluation Dice {res['dice']}")
        compare_decoder_f32(segpp_sd, device, datasets, run_dir)
    _, calls = check_attention_gradients(device)
    return {"launches": {"objectmaps": map_counts,
                         "train-decoder": train_counts,
                         "train-decoder-evaluate": eval_counts},
            "attention_backward_calls": calls}


# ------------------------------------------------------------- training

class _Data:
    """The fields of a data config the trainer reads in `step`."""
    channels = 4


def make_trainer(state_dict, device, dtype, batch, aug=None):
    """A DetectorTrainer over seeded yolov12n-seg weights; `device` None is
    the trainer's default, the card."""
    from yolou_tpu_torch.data.augment import AugHyp
    from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                         DetectorTrainer)
    from yolou_tpu_torch.models.yolo import build_yolo
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)
    cfg = DetectorTrainConfig(imgsz=IMGSZ, batch_size=batch, epochs=10,
                              warmup_epochs=3.0)
    tr = DetectorTrainer(model, _Data(), cfg, aug=aug or AugHyp(),
                         device=device)
    tr.ensure_ready(steps_per_epoch=100)
    return tr


def train(state_dict):
    """TRAIN_STEPS steps of the detector trainer on the card, bf16, 640^2,
    batch 8, mosaic on; returns the per-step statistics and what it drove,
    for `train_breakdown`."""
    import torch
    tr = make_trainer(state_dict, None, torch.bfloat16, BATCH)
    if tr.device.type != "cuda":
        raise AssertionError(f"the trainer chose {tr.device}, not the card")
    batch = make_labelled(np.random.default_rng(SEED + 4), BATCH)
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    stats = []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, parts = tr.step(batch, gen, use_mosaic=True)
        end.record()
        end.synchronize()
        vals = {"loss": loss.item(), **{k: v.item() for k, v in parts.items()}}
        stats.append({"step": i, **vals, "event_ms": start.elapsed_time(end),
                      "host_ms": (time.perf_counter() - t0) * 1e3})
        if not all(np.isfinite(v) for v in vals.values()):
            raise AssertionError(f"step {i}: non-finite loss part {vals}")
    if tr.notfinite_count() or tr.opt_count != TRAIN_STEPS:
        raise AssertionError(f"a step was skipped as non-finite: "
                             f"{tr.opt_count} updates in {TRAIN_STEPS} steps")
    after = tr.model.state_dict()
    ema = tr.ema_variables()
    moved = {"params": 0, "ema": 0, "bn_stats": 0}
    total = dict(moved)
    for k, v in after.items():
        if k.endswith("num_batches_tracked") or "dfl" in k:
            continue
        kind = "bn_stats" if "running_" in k else "params"
        total[kind] += 1
        moved[kind] += int(not torch.equal(v, before[k]))
        if kind == "params":
            total["ema"] += 1
            moved["ema"] += int(not torch.equal(ema[k], before[k]))
    # every BatchNorm sees data; a head branch of a level that got no
    # positive anchor has no gradient, so a few parameters may stand still
    if (moved["bn_stats"] != total["bn_stats"]
            or min(moved["params"], moved["ema"]) < 0.9 * total["params"]):
        raise AssertionError(f"tensors moved {moved} of {total}")
    moved = {k: f"{v}/{total[k]}" for k, v in moved.items()}
    return stats, moved, (tr, batch, gen)


def profile_step(step, steps: int = 2):
    """torch.profiler over `steps` calls of `step`: (device time in ms per
    call summed over kernels and copies, device launches per call, the six
    largest kernels as "name: ms per call"). (None, None, []) where the
    profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # kernels and copies only: an operator's row repeats its kernels' time
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.key.startswith(("Optimizer.", "ProfilerStep"))):
            continue                # the second: annotations, not kernels
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us / 1e3 / steps, e.count / steps, e.key))
    if not rows:
        return None, None, []
    rows.sort(reverse=True)
    top = [f"{name[:60]}: {ms:.3f}" for ms, _, name in rows[:6]]
    return sum(r[0] for r in rows), sum(r[1] for r in rows), top


def train_breakdown(tr, batch, gen, kernel_times, iters: int = 5):
    """Where a training step goes: the parts of `DetectorTrainer.step`, in
    its order, with CUDA events between them (each event waits for the part
    before it, so the parts add up to the step), means over `iters` steps;
    the attention kernel's and its backward's share from their times at the
    step's two shapes (4 launches each a step); a profiler window."""
    import torch
    names = ("augment", "forward", "loss", "backward", "optimizer", "ema")
    sums = dict.fromkeys(names, 0.0)

    def parts():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(7)]
        ev[0].record()
        aug = tr.augment(batch, gen, True)
        ev[1].record()
        tr.model.train()
        out = tr.model(aug["img"].permute(0, 3, 1, 2))
        ev[2].record()
        lo = tr.loss(out, aug)
        ev[3].record()
        tr.optimizer.zero_grad(set_to_none=True)
        lo.total.backward()
        ev[4].record()
        tr.apply_gradients()
        ev[5].record()
        tr.update_ema()
        ev[6].record()
        ev[6].synchronize()
        return [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]

    parts()
    for _ in range(iters):
        for name, ms in zip(names, parts()):
            sums[name] += ms / iters
    t_step = cuda_ms(lambda: tr.step(batch, gen, use_mosaic=True),
                     iters=iters, warmup=1)
    busy_ms, launches, top = profile_step(
        lambda: tr.step(batch, gen, use_mosaic=True))
    kt = kernel_times
    fwd_kernel = 4 * (kt[("L6@640", "bfloat16")]["ms"]
                      + kt[("L8@640", "bfloat16")]["ms"])
    bwd_attn = 4 * (kt[("L6@640", "bfloat16")]["backward_ms"]
                    + kt[("L8@640", "bfloat16")]["backward_ms"])
    return {"step_ms": t_step, **{f"{k}_ms": v for k, v in sums.items()},
            "attention_kernel_ms": fwd_kernel,
            "attention_kernel_share": fwd_kernel / t_step,
            "attention_backward_ms": bwd_attn,
            "attention_backward_share": bwd_attn / t_step,
            "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / t_step if busy_ms else None,
            "device_launches": launches, "top_device_kernels": top,
            "peak_memory_mb": torch.cuda.max_memory_allocated() / 2 ** 20}


def compare_train_f32(state_dict, device):
    """One f32 step, batch 2, augmentation off, same weights and batch, on
    the card (the kernel, no TF32) and on the CPU (the plain version): loss
    and global gradient norm (before clipping) within 1e-3 relative."""
    import torch
    from yolou_tpu_torch.data.augment import AugHyp
    f32_exact(torch)
    off = AugHyp(mosaic=0.0, translate=0.0, scale=0.0, fliplr=0.0, hsv_h=0.0,
                 hsv_s=0.0, hsv_v=0.0, noise_p=0.0, blur_p=0.0, bias_p=0.0)
    batch = make_labelled(np.random.default_rng(SEED + 5), 2)
    got = {}
    for dev in (device, "cpu"):
        tr = make_trainer(state_dict, dev, torch.float32, 2, aug=off)
        gen = torch.Generator(device=tr.device).manual_seed(SEED)
        loss, _ = tr.step(batch, gen, use_mosaic=False)
        got[str(dev)] = (loss.item(), tr.grad_norm.item())
    (lg, ng), (lc, nc_) = got[str(device)], got["cpu"]
    rel_loss, rel_norm = abs(lg - lc) / abs(lc), abs(ng - nc_) / abs(nc_)
    log("train", check="f32 card vs cpu", batch=2, loss_card=lg, loss_cpu=lc,
        loss_rel=rel_loss, grad_norm_card=ng, grad_norm_cpu=nc_,
        grad_norm_rel=rel_norm, tol=1e-3)
    if not (rel_loss <= 1e-3 and rel_norm <= 1e-3):
        raise AssertionError(f"f32 training step card vs cpu: loss "
                             f"{rel_loss}, gradient norm {rel_norm} > 1e-3")


def _kernel_name(line: str):
    """The band attention or a2c2f kernel a ptxas or SASS line names, with
    its I/O type (and token tile), else None: `..._kernelIf...` is the f32
    instantiation, a `_mma_` kernel bf16."""
    import re
    m = re.search(r"((?:band_attention_(?:qkv_)?|a2c2f_)(?:mma_)?kernel)"
                  r"(If|ILi(\d+)E)?", line)
    if not m:
        return None
    if m.group(2) == "If":
        return m.group(1) + "<float>"
    return m.group(1) + (f"<bf16,tile={m.group(3)}>" if m.group(3)
                         else "<bf16>")


def band_attention_build_report(ptxas_log: str, library) -> list:
    """Per band attention and whole-A2C2f kernel instantiation: registers
    and spill bytes from ptxas' report, and its tensor-core instructions
    (HMMA) in the SASS of the built library where the toolkit has
    `cuobjdump` (else None)."""
    import re
    import shutil
    report, name = {}, None
    for line in ptxas_log.splitlines():
        if "Function properties for" in line:
            name = _kernel_name(line)
        elif name and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            report[name] = {"spill_stores": int(stores),
                            "spill_loads": int(loads)}
        elif name and "Used" in line and "registers" in line:
            report[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = None
    try:
        sass = subprocess.run([tool, "-sass", str(library)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
    except (OSError, subprocess.CalledProcessError):
        pass
    for entry in report.values():
        entry["hmma"] = None
    if sass is not None:
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = _kernel_name(line)
            elif name in report and re.search(r"\bHMMA\b", line):
                report[name]["hmma"] = (report[name]["hmma"] or 0) + 1
        for entry in report.values():
            entry["hmma"] = entry["hmma"] or 0
    return [{"kernel": k, **v} for k, v in sorted(report.items())]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.kernels import build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    t0 = time.perf_counter()
    ptxas = io.StringIO()
    with contextlib.redirect_stdout(ptxas):
        lib_path = build.build(verbose=True)
    print(ptxas.getvalue(), flush=True)
    build.load()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        library=lib_path.name)
    # bf16 on the tensor cores, f32 on the SIMT path
    report = band_attention_build_report(ptxas.getvalue(), lib_path)
    if not any(e["kernel"].startswith("a2c2f_mma_kernel") for e in report):
        raise AssertionError("no bf16 a2c2f kernel in the build report")
    for entry in report:
        log("build", **entry)
        tensor_cores = "<bf16" in entry["kernel"]
        if entry["hmma"] is not None and (entry["hmma"] > 0) != tensor_cores:
            raise AssertionError(f"{entry['kernel']}: {entry['hmma']} HMMA")

    attn = check_attention(device)
    train_attn, train_attn_err = check_training_attention(device)
    nms = check_nms(device)
    a2c2f = check_a2c2f(device)

    state_dict = seeded_state_dict()
    rng = np.random.default_rng(SEED)
    requests = [make_images(rng, BATCH) for _ in range(REQUESTS)]
    kernels.reset_launch_counts()
    stats = serve(state_dict, device, torch.bfloat16, requests)
    counts = kernels.launch_counts()
    for s in stats:
        log("serve", **s)
    forwards = len(requests)
    log("serve", launches=counts, forwards=forwards)
    if counts["band_attention"] != 8 * forwards:
        raise AssertionError(f"band attention launched "
                             f"{counts['band_attention']} times, want "
                             f"{8 * forwards}")
    if counts["greedy_nms"] < 1:
        raise AssertionError("greedy NMS kernel never launched")
    if min(min(s["detections"]) for s in stats) < 1:
        raise AssertionError("an image got no detection")

    compare_f32(state_dict, device, requests[0][:2])

    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    steps, moved, driven = train(state_dict)
    train_launches = kernels.launch_counts()["band_attention_train"]
    train_backwards = kernels.backward_counts()["band_attention_train"]
    for s in steps:
        log("train", **s)
    log("train", steps=len(steps), moved=moved, launches=train_launches,
        backward_calls=train_backwards)
    if not train_launches == train_backwards == 8 * len(steps):
        raise AssertionError(
            f"training attention: {train_launches} forward launches and "
            f"{train_backwards} backward calls, want {8 * len(steps)} each")
    log("train", **train_breakdown(*driven, train_attn))
    compare_train_f32(state_dict, device)

    from yolou_tpu_torch.tools.profile_layers import \
        profile_attention_variants
    kernels.reset_launch_counts()
    variants = profile_attention_variants(batch=BATCH)
    profile_counts = kernels.launch_counts()
    log("profile", launches=profile_counts,
        **{k: round(v["ms"], 4) for k, v in variants.items()})
    if min(profile_counts["band_attention_single"],
           profile_counts["band_attention_train"]) < 1:
        raise AssertionError(f"the attention profiler launched "
                             f"{profile_counts}")

    kernels.reset_launch_counts()
    mega_stats = serve(state_dict, device, torch.bfloat16, requests,
                       mega_kernel=True)
    mega_counts = kernels.launch_counts()
    for st in mega_stats:
        log("serve-mega", **st)
    log("serve-mega", launches=mega_counts, forwards=forwards)
    if (mega_counts["a2c2f"] != 2 * forwards
            or mega_counts["band_attention"] != 0):
        raise AssertionError(f"mega_kernel=True launched {mega_counts}, want "
                             f"{2 * forwards} of a2c2f and no band attention")
    if min(min(st["detections"]) for st in mega_stats) < 1:
        raise AssertionError("an image got no detection with mega_kernel")
    compare_mega(state_dict, device, requests)

    eval_counts = evaluate(state_dict, device)
    dec = train_decoder_phase(state_dict, device)

    src = "yolou_tpu_torch/csrc/"
    pallas = "yolou_tpu/ops/pallas_attn.py"
    l6 = train_attn[("L6@640", "bfloat16")]
    # the single-head entry at the shape its launches were counted at
    single = train_attn[("profile-single", "bfloat16")]
    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": "band_attention", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "launches": counts["band_attention"], **{k: attn[k] for k in keys},
         "attention_library_ms": attn["attention_library_ms"],
         "launches_by_path": {
             "serve": counts["band_attention"],
             "evaluate": eval_counts["band_attention"],
             **{k: v["band_attention"] for k, v in dec["launches"].items()}},
         "backward_calls": dec["attention_backward_calls"]},
        {"name": "greedy_nms", "route": "cuda",
         "source": src + "greedy_nms.cu",
         "replaces": "yolou_tpu/ops/pallas_nms.py:97",
         "launches": counts["greedy_nms"], **{k: nms[k] for k in keys},
         "launches_by_path": {
             "serve": counts["greedy_nms"],
             "evaluate": eval_counts["greedy_nms"],
             **{k: v["greedy_nms"] for k, v in dec["launches"].items()}}},
        {"name": "band_attention_train", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":243",
         "launches": train_launches,
         "backward_calls": train_backwards,
         **dict({k: l6[k] for k in keys}, max_abs_err=train_attn_err)},
        {"name": "band_attention_single", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":120",
         "launches": profile_counts["band_attention_single"],
         **{k: single[k] for k in keys}},
        {"name": "a2c2f", "route": "cuda", "source": src + "a2c2f.cu",
         "replaces": "yolou_tpu/ops/pallas_a2c2f.py:192",
         "launches": mega_counts["a2c2f"],
         "staged_ms": a2c2f["staged_ms"], **{k: a2c2f[k] for k in keys}},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
