#!/usr/bin/env python3
"""Smoke run of the PyTorch port (yolou_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, one or more output lines each:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA;
  2. build   - nvcc builds the kernels from yolou_tpu_torch/csrc; the band
               attention and whole-A2C2f kernels' registers, spills and
               tensor-core (HMMA, HGMMA) instructions: bf16 must have them
               (the wgmma kernels HGMMA only), f32 (FMA units) must not;
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
               A2C2f module on the same weights; also at the
               long bands (yolov12s / x layer 8 at 640^2 in f32, yolov12n
               at 1280^2 in bf16, kernel C at 1024 and 1936 tokens), the
               short paths of kernels A and C (bands of 64 tokens or
               fewer, one launch) timed against the streamed path at the
               160^2 bands (f32 within 1e-5, bf16 within 2^-7: kernel A
               absolute, kernel C of the largest magnitude; kernel C also
               at heads of 48 and 16), the f32 and bf16 k/v projections
               beside one torch.addmm at 640^2 (yolov12s / x's layer 8
               too), `a2c2f` at mlp_ratio 1.2 and at
               yolov12l's layer 8 (f32, 32-token tiles); heads of 48 and
               16 in kernels A and C and the single-head entry, and `a2c2f`
               with one head of 48 and with five stages, both types; two
               heads of 128 in kernels A and C (the blocked path), both
               types;
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
  8. shapes  - the shapes past yolov12n at 640^2 (the streamed band
               attention path, the MLP width, the f32 token tiles, the
               residual A2C2f), through the entry points: seeded, calibrated
               yolov12s-seg serving 2 requests of 8 at 640^2 in f32 (8 kernel
               A launches a forward, a detection on every image; f32 card vs
               CPU) and one of 8 at 1280^2 in bf16; one f32 training step of
               yolov12n at 1024^2, batch 2, card vs CPU (kernel C 8 + 8);
               yolov12l at 640^2, f32, batch 2, with mega_kernel (one a2c2f
               launch a forward, within 1e-3 of the flag off); a residual
               A2C2f (128, n 2, area 4, mlp_ratio 1.2) at (8, 128, 40, 40)
               in bf16 eval (4 kernel A launches) and f32 training forward
               and backward (4 kernel C launches and 4 backward calls), each
               against the same module on the plain versions; modules the
               port refused before kernel A's wide form, the bf16 `a2c2f`'s
               h in global memory and the blocked path (heads of 128 and 512
               in AAttn, eval and train mode, and `a2c2f` folds of c_ 256 in
               two heads and 96 in one), each against its plain version.
  9. evaluate - YOLO-Seg++ (`build_segpp`, bf16) with the same detector
               weights and a seeded decoder; an Evaluator at 160^2, batch 16,
               takes 3 batches of seeded images and elliptic masks from
               memory with HD95 on: 8 band attention launches and one NMS
               launch a step, 48 images, finite Dice, precision and recall in
               [0, 1]; images/s and the step's parts; then one f32 step on
               the card against the CPU; every kernel A launch of both on
               its short path.
 10. train-decoder - the YOLO-Seg++ training pipeline at 160^2, bf16, with
               the same detector weights: seeded images and elliptic masks
               in memory (512 train, 128 val, 128 test); objectmaps of every
               split from the port's generator at batch 128 (8 band
               attention launches a batch, no NMS); `DecoderTrainer.train()`
               over them, batch 128, 3 epochs (12 updates: finite history,
               the loss not up by more than 0.2, decoder moved, encoder
               bit-identical, best.ckpt / last.ckpt / history.csv
               written); last.ckpt, the JAX package's decoder training
               state, read into a fresh trainer bit-identical to the one
               that wrote it (parameters, statistics, AdamW's moments and
               step, the schedule) and written again byte for byte, its
               bytes and write and read seconds; one more update on both
               from the same batch (bit-identical where every kernel is
               deterministic, else within the tolerance `twin_steps`
               states); then resumed from last.ckpt with 4 epochs (one
               more epoch, step 16);
               the step's time, parts, busy share and launches; an Evaluator
               on the test split with the trained decoder (8 band attention
               and one NMS launch a step); one f32 step card vs CPU; kernel
               A's gradient through an eval-mode AAttn against the plain
               version's, and the whole-A2C2f kernel's refusal of an input
               that requires grad.
 11. finetune - the detector stage at 160^2, batch 16, bf16: seeded
               yolov12n-seg weights built with a 3-channel stem and
               inflated to 4 channels (`inflate_stem_to_4ch`), calibrated;
               `DetectorTrainer.train()` over seeded in-memory splits of
               elliptic tumours (128 train, 64 val) with validation every
               epoch, 3 epochs with close_mosaic 1 (finite history, mAP50
               and mAP50-95 in [0, 1], best.ckpt and last.ckpt, 8 forward
               launches of kernel C a step, each on its short path, and 8
               backward calls, 8 of
               kernel A and 1 of kernel B a validation batch, the training
               model's mode and BatchNorm statistics unchanged by each
               validation); last.ckpt, the JAX package's tree-form
               training state, read into a fresh trainer bit-identical to
               the one that wrote it (parameters, statistics, EMA, SGD
               momentum, counters) and written again byte for byte, its
               bytes and write and read seconds; one more step on both
               from the same batch and generator state; then resumed from
               last.ckpt for a fourth epoch and validation; a training step's time, a validation pass's
               images/s, parts (upload, forward, NMS, copy back, host
               matching + AP, timed through the validator's own parts) and
               busy share; in f32 on the card and the CPU, the calibrated
               weights validated (metrics within 1e-4, the same number of
               detections on every image) and the best EMA weights (metrics
               within 1e-4; detections the same but for near-ties within
               1e-4 of an NMS decision, each named; the EMA read from the
               card's best.ckpt by a CPU trainer); a `.ckpt` model file of
               the best EMA weights
               read back onto the card (forward bit-identical) and a
               Predictor over it answering one request.
 12. cli     - the Quickstart through `python -m yolou_tpu_torch`'s
               dispatcher at the reference configuration (yolov12n-seg, 4
               channels, nc=1, 160^2, bf16) from PNG files on disk, with
               cv2 blocked by a meta-path finder: a dataset of seeded
               ellipses (256 train, 64 val, 64 test; 4-channel images,
               gray masks, 32-vertex polygon labels) written by the port's
               PNG writer and read back byte for byte, each PNG filter type
               round-tripped; `--help` as a process; `train-detector` (2
               epochs, validation each), `generate-objectmaps`,
               `train-decoder` (3 epochs), `evaluate`, `predict` (160^2,
               and 640^2 with `--retina-masks`), `val --rect`, `convert`
               both ways (the .pt loads strictly, the forward
               bit-identical) in this process, each with exact launch
               counts (kernel C 8 + 8 backward a step, A 8 and B 1 a
               batch where they run, a2c2f 0); `val` as a process of its
               own; `val` (near-ties named) and `evaluate` in f32 on the
               card against `--device cpu`; each command's wall seconds,
               host decode and resize rates, predict images/s, the epochs'
               seconds.
 13. export  - `export` of the cli phase's seeded, calibrated init.ckpt at
               640^2, batch 8, in bf16 and in f32 through the dispatcher:
               no kernel launch while tracing, 8 kernel A and 1 kernel B
               operator nodes in each program's graph; each program run as
               an ExportedModel on 8 seeded images, exactly 8 A + 1 B
               launches a call, beside the live Predictor.infer (f32: boxes
               within 1e-3, scores within 1e-5, `valid` equal; bf16: equal
               detection counts but for near-ties); the bf16 call against
               infer (CUDA events and device ms, 20 calls each, in turns);
               then `--kind segpp` of the cli phase's YOLO-Seg++ at 160^2,
               batch 16, bf16: the mask against the live model's, pixels
               differing only within 1e-2 of 0.5.
 14. profile - `profile --batch 8 --imgsz 640` (bf16, every prefix, device
               ms from torch.profiler): no negative row, the total within
               15 % of one whole forward's device ms; the costliest rows
               and where layers 6 and 8 fall; then `profile --attn`.
 15. visualize-logits - one PNG of the cli phase with its trained detector,
               f32, on the card and with `--device cpu`: probabilities
               within 1e-5, the printed statistics equal, 8 kernel A
               launches on the card and none on the CPU.
 16. families - yolov8n-seg and yolo11n-seg (4 ch, nc=1, seeded weights
               calibrated as the serve phase's, the head bias warm-started):
               for each, a Predictor answering 3 requests of 8 images at
               640^2 in bf16 (a detection on every image, kernel B once a
               request, no attention kernel), f32 on the card against the
               CPU (preds, raw maps, mask coefficients and protos within
               1e-3, keep-sets equal but for near-ties, NMS on the same
               input identical), 3 training steps (batch 8, 640^2, bf16,
               mosaic on; no attention kernel); the batch-8 forward of
               yolov12, yolov8 and yolo11 timed in turns (CUDA events and
               device ms and launches from torch.profiler) and yolo11's PSA
               stage alone; then, in the cli phase's directory with cv2
               blocked, `convert --arch` of a port-written `.pt`, `predict`,
               `val` at 160^2, `export` at 640^2 f32 (one kernel B launch a
               call, boxes and scores against `Predictor.infer`) and
               `train-detector --epochs 1` from the family's `.ckpt`: every
               file written names the family, the fine-tuned one loads back.
 17. sources - yolov12n-seg at 640^2, bf16, with the serve phase's
               weights: a Predictor over a 24-frame MJPG `.avi` written by
               `cv2.VideoWriter` (24 results `#frame0` ... `#frame23`, 8
               kernel A launches a forward, one kernel B launch a chunk of
               8) and over a list of 8 PIL RGBA images (`pil_0` ...
               `pil_7`); the clip in f32 on the card against the CPU
               (detections equal but for near-ties, each named); the
               camera, stream (a refused localhost port) and screenshot
               routes by their errors.
 18. parallel - data parallel at full width, yolov12n-seg: (a) a
               DetectorTrainer over `make_mesh(1)` (NCCL) against the
               mesh-less one, one bf16 step at 640^2, batch 8, each
               (bit-identical, or the non-deterministic ops named); (b)
               two gloo ranks, both on cuda:0 (`parallel.mesh.launch`),
               one f32 step at 640^2, global batch 8, mosaic on, against
               this process on the same batch and generator state (loss
               rtol 3e-4; parameters, EMA and BatchNorm statistics rtol
               1e-3 / atol 5e-5; 8 kernel C launches and 8 backward calls
               per rank); (c) one f32 DecoderTrainer update at 160^2,
               global batch 128 (loss 1e-5 relative, decoder 3e-5
               absolute, encoder exact); (d) an f32 Evaluator over 3
               batches of 16 at 160^2 with HD95 (the metrics within 1e-6; 8
               kernel A and 1 kernel B launches per rank a step); the bf16
               step's ms per rank beside one process's, the gloo gradient
               all-reduce alone; (e) `train-detector --data-parallel 1`
               through the dispatcher (one NCCL rank) and `--data-parallel
               2` refused by name on one card.
 19. model_axis - the data x model mesh at full width, yolov12n-seg, 160^2,
               global batch 16, mosaic on, `param_sharding_rules(min_size=
               2**12)` (99 weights cut): (a) 4 gloo ranks on cuda:0 as a 2
               x 2 mesh and 2 as a 1 x 2 mesh, 3 f32 steps each against
               this process (loss and parts rtol 3e-4; the gathered
               parameters, EMA and BatchNorm statistics rtol 1e-3 / atol
               5e-5; the gradient norm 1e-5 against one process's; the
               replicated tensors bit-identical across each model group;
               99 weights cut and half their bytes gone in every rank;
               kernel C 8 + 8 a step in every rank, every launch on its
               short path, f32 and bf16); a bf16 step per rank
               timed, with the host ms of the model group's collectives
               (`parallel.mesh.model_comm`), beside one process's; (b)
               `tools/dryrun.py::dryrun_multichip(4)` on cuda:0 x 4 (phase
               2 within 3e-4 of phase 1), run beside the two meshes' f32
               steps, each mesh's bf16 step then timed alone; (c) the 2 x
               2 state file before any step byte for byte one process's,
               its last.ckpt read by one process and one more step on both
               within `twin_steps`' tolerance.
 20. demo    - `tools/run_demo.py`'s four stages, each a process, on the
               demo's synthetic set (64 / 16 / 16 at 160^2, seed 7) at a
               short schedule (6 + 6 epochs): the files, finite metrics,
               the objectmap AUC, each stage's exact launches (kernel C's on
               its short path). The full
               120 + 120 run is `python -m yolou_tpu_torch.tools.run_demo`.
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
import tempfile
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
# exps a second of the special-function units of one H100 SXM (16 an SM a
# clock, FlashAttention-3's figure): the floor of an attention whose
# operations bound is below it, one exp a score
EXP_RATE = 3.9e12


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    from yolou_tpu_torch.tools.profile_layers import card_name_and_power_limit
    return card_name_and_power_limit()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of `fn` on the current stream (CUDA events
    around `iters` back-to-back calls, after `warmup` calls): the attention
    profiler's timer, so that both read one clock the same way."""
    import torch
    from yolou_tpu_torch.tools.profile_layers import call_ms
    return call_ms(fn, torch.device("cuda"), iters, warmup)


class EventsMs(float):
    """A time from CUDA events around back-to-back calls (host included),
    given where torch.profiler recorded no device time: `times_source`
    names the fields of a row that hold one."""


def kernel_times(fn, iters: int = 20):
    """(device_ms, call_ms) per call of `fn`: the card's own time (kernel and
    copy time from torch.profiler, no host time and no gaps between
    launches), the time every kernel below is given as; and CUDA events
    around back-to-back calls, which also count the host wherever it, not
    the card, sets the pace (a kernel of a few microseconds behind a Python
    wrapper)."""
    from yolou_tpu_torch.tools.profile_layers import device_ms
    for attempt in range(3):     # each attempt takes up to three traces
        try:
            return device_ms(fn, iters), cuda_ms(fn, iters)
        except RuntimeError as e:
            log("profiler", error=str(e), attempt=attempt)
    # a profiler that recorded no device time in nine traces (seen once on
    # an H100 in three, never in 400 profiles of a probe there): the CUDA
    # events' time, marked, in place of the device time
    log("profiler", fallback="CUDA events")
    call = cuda_ms(fn, iters)
    return EventsMs(call), call


def times_source(row: dict) -> str:
    """Where a kernel row's times come from: "torch.profiler", or the
    fields whose number is CUDA events' host-inclusive time instead."""
    events = sorted(k for k, v in row.items() if isinstance(v, EventsMs))
    return "cuda_events: " + ", ".join(events) if events else "torch.profiler"


def device_kernels(fn, calls: int = 5) -> list:
    """The device kernels and copies torch.profiler records per call of
    `fn` (the names of `calls` calls, divided among them; raises if they do
    not divide evenly). A trace that comes back with no device event at all
    is taken again, up to three times, as `device_ms` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    if len(names) % calls:
        raise AssertionError(f"{len(names)} device events in {calls} calls")
    return names[:len(names) // calls]


def bound(nbytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of bytes over the memory rate and operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def exp_floor(g: int, heads: int, n: int) -> float:
    """Milliseconds the exp unit needs for one exp a score of G bands of N
    tokens and `heads` heads, at `EXP_RATE`: a floor beside `bound`, which
    stays the roofline of bytes and operations."""
    return g * heads * n * n / EXP_RATE * 1e3


def device_kernel_ms(fn, iters: int = 20) -> dict:
    """Device milliseconds per call of `fn` by device kernel (torch.profiler,
    `iters` calls after 3 warm-up), keyed by the kernel's name and template
    arguments (its namespace and parameters dropped)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):           # a trace that comes back empty is taken again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                m = re.search(r"\w+_kernel(?:<[^>]*>)?", e.name())
                name = m.group(0) if m else e.name()
                out[name] = out.get(name, 0.0) + e.duration_ns() / 1e6 / iters
        if out:
            return out
    raise RuntimeError("torch.profiler recorded no device time")


def dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def f32_exact(torch) -> None:
    """Full-f32 matmuls and convolutions (no TF32) for exact comparisons."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- kernel A

BOTH = ("float32", "bfloat16")
SHORT = {"float32": "f32", "bfloat16": "bf16"}


# the short paths: f32 within 1e-5, bf16 within 2^-7 (one bf16 step of an
# output in [1, 2); kernel C's of its largest magnitude)
SHORT_TOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def paths_in_turns(fn_of_path, paths):
    """path -> device ms per call of `fn_of_path(path)()`, the mean of two
    turns (each path in order, then in reverse)."""
    times = {p: [] for p in paths}
    for path in (*paths, *paths[::-1]):
        times[path].append(kernel_times(fn_of_path(path))[0])
    return {p: sum(t) / len(t) for p, t in times.items()}


def check_attention(device):
    """Kernel A against its plain version at the serving (640^2, batch 8),
    evaluation (160^2, batch 16) and objectmap (160^2, batch 128) shapes,
    and at the long bands of the larger scales and images; times of the
    kernel, the plain version and, as a yardstick of the
    attention part alone (no one PyTorch call does projection + attention),
    scaled_dot_product_attention over the q, k, v that the plain projection
    gives. At the 160^2 bands the short path is also timed against the
    streamed one in turns; where a band streams, its first device kernel
    (the k/v projection) beside its bound, its plain version and one
    torch.addmm of the same columns, in both types. Heads of 48 and 16
    (padded to 64 and 32 in the wrapper) at layer 8's band, both types.
    Kernel A's wide form at four widths its q-projecting kernel does not
    fit (its first device kernel then the q | k | v projection, beside one
    torch.addmm of all 3C columns). Two heads of 128 at layer 8's bands
    (the blocked path: the same projection, then kernel C's blocked form,
    whose score work is 2x the head's), both types."""
    import torch
    import torch.nn.functional as F
    from yolou_tpu_torch.kernels.attention import (
        _launch_qkv_attention, area_attention_qkv_fused,
        area_attention_qkv_fused_plain, attention_plan, padded_head_dim)
    f32_exact(torch)
    # serving: 640^2, batch 8; evaluation: 160^2, batch 16; objectmaps:
    # 160^2, batch 128; then the long bands
    cases = [("L6@640", 4 * BATCH, 400, 64, 2, BOTH),
             ("L8@640", BATCH, 400, 128, 4, BOTH),
             # the default (f32) commands' batch 16 at 640^2
             ("L6@640b16", 4 * EVAL_BATCH, 400, 64, 2, ("float32",)),
             ("L8@640b16", EVAL_BATCH, 400, 128, 4, ("float32",)),
             ("L6@160", 4 * EVAL_BATCH, 25, 64, 2, BOTH),
             ("L8@160", EVAL_BATCH, 25, 128, 4, BOTH),
             # a data shard of the model_axis phase's 2 x 2 mesh
             ("L6@160/2", 4 * EVAL_BATCH // 2, 25, 64, 2, BOTH),
             ("L8@160/2", EVAL_BATCH // 2, 25, 128, 4, BOTH),
             ("L6@160b128", 4 * DEC_BATCH, 25, 64, 2, BOTH),
             ("L8@160b128", DEC_BATCH, 25, 128, 4, BOTH),
             ("s L8@640", BATCH, 400, 256, 8, BOTH),
             ("x L8@640", BATCH, 400, 384, 12, BOTH),
             ("L6@1280", 4 * BATCH, 1600, 64, 2, BOTH),
             ("L8@1280", BATCH, 1600, 128, 4, ("bfloat16",)),
             # heads no yolov12 graph builds: two of 48 (padded to 64, the
             # streamed path) and two of 16 (padded to 32)
             ("L8@640 hd48", BATCH, 400, 96, 2, BOTH),
             ("L8@640 hd16", BATCH, 400, 32, 2, BOTH),
             # kernel A's wide form (widths the q-projecting kernel does
             # not fit): A2C2f(1856, 1856)'s c_ 928 in 29 heads, f32's
             # first wide width in heads of 32, AAttn(512, 8) and AAttn(640,
             # 10) (heads of 64), all at area 4 of 40^2
             ("c_928 h29", 4, 400, 928, 29, ("bfloat16",)),
             ("c_1344 h42", 4, 400, 1344, 42, ("float32",)),
             ("AAttn(512,8)", 4, 400, 512, 8, ("bfloat16",)),
             ("AAttn(640,10)", 4, 400, 640, 10, ("float32",)),
             # heads wider than 64 (the blocked path): AAttn(256, 2)
             ("L8@640 hd128", BATCH, 400, 256, 2, BOTH)]
    rng = np.random.default_rng(SEED)
    worst, times = 0.0, {}
    for name, g, n, c, heads, dtypes in cases:
        x = rng.normal(size=(g, n, c)).astype(np.float32)
        w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c)).astype(np.float32)
        b = rng.normal(0, 0.1, (3 * c,)).astype(np.float32)
        for dtype in (getattr(torch, d) for d in dtypes):
            xt = torch.from_numpy(x).to(device, dtype)
            wt = torch.from_numpy(w).to(device, dtype)
            bt = torch.from_numpy(b).to(device)
            hdp = padded_head_dim(c // heads)
            plan = attention_plan(g, n, heads * hdp, dtype, hd=hdp)
            o, v = area_attention_qkv_fused(xt, wt, bt, heads)
            o_ref, v_ref = area_attention_qkv_fused_plain(xt, wt, bt, heads)
            v_err = (v.float() - v_ref.float()).abs().max().item()
            err = max((o.float() - o_ref.float()).abs().max().item(), v_err)
            tol = (SHORT_TOL if plan.path == "short"
                   else ATTN_TOL)[dtype_name(dtype)]
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
            paths = {}
            if plan.streamed:    # its two device kernels, each timed
                split = device_kernel_ms(
                    lambda: area_attention_qkv_fused(xt, wt, bt, heads))
                paths = {"projection_ms": sum(
                             v for k, v in split.items() if "projection" in k),
                         "attention_ms": sum(
                             v for k, v in split.items()
                             if "projection" not in k),
                         "device_kernels": sorted(split)}
            else:
                paths = {"device_kernels": sorted(device_kernel_ms(
                    lambda: area_attention_qkv_fused(xt, wt, bt, heads)))}
            if plan.streamed:
                wide = plan.path in ("wide", "blocked")   # q | k | v first
                paths.update(streamed_bounds(g, n, c, dtype_name(dtype),
                                             wide))
                # the projection alone: its plain version and one library
                # call
                paths.update(projection_yardsticks(xt, wt, bt, wide))
            if plan.path == "short" and hdp == 32:
                paths.update({f"{p}_ms": t for p, t in paths_in_turns(
                    lambda p: lambda: _launch_qkv_attention(xt, wt, bt,
                                                            heads, p),
                    ("short", "streamed")).items()})
            floor_ms = exp_floor(g, heads, n)
            log("kernel", name="band_attention", case=name,
                shape=f"({g},{n},{c})h{heads}", dtype=dtype_name(dtype),
                path=plan.path, device_kernels_a_call=plan.launches,
                rows=plan.rows, max_abs_err=err, v_max_abs_err=v_err,
                tol=tol, ms=ms,
                plain_ms=plain_ms, attention_library_ms=attn_lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, exp_floor_ms=floor_ms,
                call_ms=call_ms,
                plain_call_ms=plain_call_ms,
                attention_library_call_ms=attn_lib_call_ms, **paths)
            if not finite or not err <= tol:
                raise AssertionError(f"band attention {name} {dtype}: "
                                     f"max|d| {err} > {tol} or non-finite")
            worst = max(worst, err)
            times[(name, dtype)] = {"ms": ms, "call_ms": call_ms,
                                    "plain_ms": plain_ms,
                                    "bound_ms": bound_ms,
                                    "bound_by": bound_by,
                                    "exp_floor_ms": floor_ms,
                                    "library_ms": None,
                                    "attention_library_ms": attn_lib_ms,
                                    "max_abs_err": err,
                                    "v_max_abs_err": v_err,
                                    "streamed": plan.streamed,
                                    "path": plan.path, **{
                                        k: v for k, v in paths.items()
                                        if k.startswith(("projection",
                                                         "attention_"))
                                        or k == "device_kernels"}}
    return times


def streamed_bounds(g: int, n: int, c: int, dtype: str,
                    wide: bool = False) -> dict:
    """The bound of each device kernel of kernel A's streamed path at G
    bands of N tokens at width C: the k/v projection (x read, k and v
    written, w's k and v columns and their bias read; 4 G N C^2 flop) and
    the attention (x, k and v read, o written, w's q columns and bias read;
    the q projection's 2 G N C^2 and q.k^T and p.v's 4 G N^2 C flop). In
    the `wide` form the projection takes q too (x read, q, k and v written,
    all of w and b read; 6 G N C^2 flop) and the attention reads q, k and v
    and writes o (4 G N^2 C flop)."""
    elt, rows = (4 if dtype == "float32" else 2), g * n
    out = {}
    parts = (("projection", elt * (3 * rows * c + 2 * c * c) + 8 * c,
              4 * rows * c * c),
             ("attention", elt * (4 * rows * c + c * c) + 4 * c,
              2 * rows * c * c + 4 * g * n * n * c))
    if wide:
        parts = (("projection", elt * (4 * rows * c + 3 * c * c) + 12 * c,
                  6 * rows * c * c),
                 ("attention", elt * 4 * rows * c, 4 * g * n * n * c))
    for part, nbytes, flops in parts:
        out[f"{part}_bound_ms"], out[f"{part}_bound_by"] = bound(
            nbytes, flops, dtype)
    return out


def projection_yardsticks(x, w, b, wide: bool = False) -> dict:
    """The k/v projection's plain version's device ms (the plain version's
    projection of the same columns: f32 product and bias, rounded to x's
    type) and one library call's (torch.addmm over the same columns in x's
    type, TF32 off; in bf16 with the bias rounded to bf16, as the call
    takes it), on (G, N, C) x; of all 3C q | k | v columns in the `wide`
    form."""
    import torch
    g, n, c = x.shape
    rows = g * n
    first = 0 if wide else c
    wkv, bkv = w[:, first:].contiguous(), b[first:].contiguous()
    bkv_lib = bkv.to(x.dtype)
    x2 = x.view(rows, c)
    return {"projection_plain_ms": kernel_times(
                lambda: (torch.matmul(x.float(), wkv.float()) + bkv
                         ).to(x.dtype))[0],
            "projection_library_ms": kernel_times(
                lambda: torch.addmm(bkv_lib, x2, wkv))[0]}


# ------------------------------------------------------------- kernel C

def check_training_attention(device):
    """`area_attention_fused` (and `area_attention`, its one-head form)
    against the plain version: outputs and gradients at the two training
    shapes of yolov12n at 640^2 and batch 8, at the two the fine-tune phase
    gives them (160^2, batch 16), at the two shapes the attention
    profiler gives them at batch 8, and at yolov12n's layer-6 bands at
    1024^2 (f32) and 1408^2 (bf16), batch 8; times of kernel, plain
    version and the one PyTorch call that computes the function
    (scaled_dot_product_attention), a yardstick only. The bands of 64
    tokens or fewer (160^2) take the short path, held to `SHORT_TOL` of the
    output's largest magnitude in bf16 and timed against the streamed path
    in turns. Heads of 48, 16 and 96, multi-head and single, both types, at
    400 tokens and at 25, padded inside the kernel: one device kernel a
    call (torch.profiler) counted as "<path> <type> padded", and timed
    beside the route of copies the wrapper took before (`pad_heads`, the
    kernel width's own form, `cut_heads`: `copies_ms`); two heads of 128 at
    400 and one head of 128 (the blocked path), both types; the f32 cluster
    form at two heads of 256 and of 512."""
    import torch
    import torch.nn.functional as F
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.kernels.attention import (
        _launch_band_attention, area_attention, area_attention_fused,
        area_attention_fused_plain, area_attention_plain, attention_backward,
        attention_plan, cut_heads, in_kernel_pad, pad_heads, padded_head_dim)
    from yolou_tpu_torch.tools.profile_layers import HEADS, attention_shapes
    f32_exact(torch)
    cases = [("L6@640", 4 * BATCH, 400, 64, 2, BOTH),
             ("L8@640", BATCH, 400, 128, 4, BOTH),
             ("L6@160", 4 * EVAL_BATCH, 25, 64, 2, BOTH),
             ("L8@160", EVAL_BATCH, 25, 128, 4, BOTH),
             # a data shard of the model_axis phase's 2 x 2 mesh
             ("L6@160/2", 4 * EVAL_BATCH // 2, 25, 64, 2, BOTH),
             ("L8@160/2", EVAL_BATCH // 2, 25, 128, 4, BOTH),
             ("single", 64, 400, 32, 1, BOTH),
             # the default (f32) train-detector's batch 16 at 640^2
             ("L6@640b16", 4 * EVAL_BATCH, 400, 64, 2, ("float32",)),
             ("L8@640b16", EVAL_BATCH, 400, 128, 4, ("float32",)),
             ("L6@1024", 4 * BATCH, 1024, 64, 2, ("float32",)),
             ("L6@1408", 4 * BATCH, 1936, 64, 2, ("bfloat16",)),
             ("L8@640 hd48", BATCH, 400, 96, 2, BOTH),
             ("L8@640 hd16", BATCH, 400, 32, 2, BOTH),
             ("single hd48", 64, 400, 48, 1, BOTH),
             ("single hd16", 64, 400, 16, 1, BOTH),
             # the short path at heads the wrapper pads: 48 -> 64, 16 -> 32
             ("L8@160 hd48", EVAL_BATCH, 25, 96, 2, BOTH),
             ("L8@160 hd16", EVAL_BATCH, 25, 32, 2, BOTH),
             # heads wider than 64: the blocked path
             ("L8@640 hd128", BATCH, 400, 256, 2, BOTH),
             ("single hd128", 64, 400, 128, 1, BOTH),
             # padded inside the kernel past 64 (to 128) and the f32 cluster
             # form at heads of 256 and 512
             ("L8@640 hd96", BATCH, 400, 192, 2, BOTH),
             ("single hd96", 64, 400, 96, 1, BOTH),
             ("L8@640 hd256", BATCH, 400, 512, 2, ("float32",)),
             ("L8@640 hd512", BATCH, 400, 1024, 2, ("float32",))]
    for name, shape, heads in zip(("profile-single", "profile-fused"),
                                  attention_shapes(BATCH), (1, HEADS)):
        cases.append((name, *shape, heads, BOTH))
    rng = np.random.default_rng(SEED + 3)
    results = {}
    for name, g, n, c, heads, dtypes in cases:
        single = heads == 1
        arrays = [rng.normal(size=(g, n, c)).astype(np.float32)
                  for _ in range(4)]
        kname = "band_attention_single" if single else "band_attention_train"
        for dtype in (getattr(torch, d) for d in dtypes):
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
            floor_ms = exp_floor(g, heads, n)
            hd = c // heads
            hdp = padded_head_dim(hd)
            plan = attention_plan(g, n, heads * hdp, dtype, projection=False,
                                  hd=hdp)
            tol = ATTN_TOL[dn]
            paths = {}
            padded = in_kernel_pad(hd, dtype)
            if padded:
                # one device kernel a call, on the padded key; the copies'
                # route beside it
                per_call = device_kernels(fn)
                kernels.reset_launch_counts()
                with torch.no_grad():
                    fn()
                counted = kernels.path_counts(kname)
                want_key = f"{plan.path} {SHORT[dn]} padded"
                if len(per_call) != 1 or counted != {want_key: 1}:
                    raise AssertionError(f"{kname} {name} {dn}: device "
                                         f"kernels {per_call}, paths "
                                         f"{counted}")

                def copies():
                    qp, kp, vp = (pad_heads(t, heads, hdp) for t in (q, k, v))
                    return cut_heads(_launch_band_attention(
                        qp, kp, vp, heads, plan.path, scale=hd ** -0.5),
                        heads, hd)
                with torch.no_grad():
                    paths = {"copies_ms": kernel_times(copies)[0],
                             "device_kernels": per_call}
            if plan.path == "short":
                tol = SHORT_TOL[dn] * (1.0 if dn == "float32"
                                       else ref.float().abs().max().item())
                if hdp == c // heads:
                    with torch.no_grad():
                        paths = {f"{p}_ms": t for p, t in paths_in_turns(
                            lambda p: lambda: _launch_band_attention(
                                q, k, v, heads, p),
                            ("short", "streamed")).items()}
            log("kernel", name=kname, case=name,
                shape=f"({g},{n},{c})h{heads}", dtype=dn,
                path=plan.path, rows=plan.rows,
                **paths, max_abs_err=err,
                tol=tol, grad_max_abs_err=gerr, grad_tol=GRAD_TOL[dn],
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                library_max_abs_err=lib_err, backward_ms=bwd_ms,
                bound_ms=bound_ms, bound_by=bound_by, exp_floor_ms=floor_ms,
                call_ms=call_ms,
                plain_call_ms=plain_call_ms, library_call_ms=lib_call_ms)
            if not (torch.isfinite(o).all() and err <= tol
                    and gerr <= GRAD_TOL[dn]):
                raise AssertionError(
                    f"{kname} {name} {dn}: max|d| {err} (tol {tol}),"
                    f" gradients {gerr} (tol {GRAD_TOL[dn]}) or non-finite")
            results[(name, dn)] = {
                "max_abs_err": err, "tol": tol, "ms": ms, "call_ms": call_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "exp_floor_ms": floor_ms,
                "library_ms": lib_ms, "backward_ms": bwd_ms,
                "streamed": plan.streamed, "path": plan.path,
                "padded": padded, **paths}
    return results


# ------------------------------------------------- the whole-A2C2f kernel

def a2c2f_work(shape, c_, c2, n_stages, area, elt, hid=None):
    """(bytes, operations) of one A2C2f block: x read, out written, each
    weight read once; the GEMMs, the per-head score and p.v products (width
    32 each, so 4 nb c_ a token) and the 49-tap stencil. `hid`: the MLP's
    width as the kernel is given it (default 2 c_)."""
    B, H, W, cin = shape
    tokens, nb = B * H * W, H * W // area
    hid = 2 * c_ if hid is None else hid
    per_block = 2 * c_ * (3 * c_ + c_ + hid + hid)
    gemm = 2 * cin * c_ + 2 * n_stages * per_block + 2 * (n_stages + 1) * c_ * c2
    flops = tokens * (gemm + 2 * n_stages * (4 * nb * c_ + 2 * 49 * c_))
    weights = (cin * c_ + 2 * n_stages * per_block // 2
               + (n_stages + 1) * c_ * c2)
    small = 4 * (c_ + c2
                 + 2 * n_stages * (3 * c_ + 49 * c_ + c_ + c_ + hid + c_))
    return elt * (tokens * (cin + c2) + weights) + small, flops


def seeded_a2c2f(c1: int, c2: int, n: int, area: int, device, seed: int,
                 mlp_ratio: float = 2.0, residual: bool = False):
    """A seeded A2C2f attention block in eval mode whose BatchNorms carry
    random statistics (so that folding them is not the identity) and a scale
    near 0.3, which keeps the block's activations of order 1."""
    from yolou_tpu_torch.nn.attention import A2C2f
    return seeded_module(A2C2f(c1, c2, n, a2=True, area=area,
                               mlp_ratio=mlp_ratio, residual=residual),
                         device, seed)


def seeded_module(module, device, seed: int):
    """`module` with seeded weights in eval mode, its BatchNorms carrying
    random statistics near a scale of 0.3 (`seeded_a2c2f`)."""
    import torch
    from torch import nn
    from yolou_tpu_torch.models.yolo import init_weights
    gen = torch.Generator().manual_seed(seed)
    m = init_weights(module, gen)
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
    batch 8), at a small shape with four bands, f32 and bf16, at the two
    yolov12n shapes with mlp_ratio 1.2 (an MLP 154 / 307 wide, padded to
    160 / 320 in bf16), at yolov12l's layer 8 at 640^2 in f32 (4 stages;
    32-token tiles), at A2C2f(96, 96) (one head of 48, padded to 64 by the
    fold) and at five stages, both types, and at A2C2f(512, 512,
    mlp_ratio=4.0) in bf16 (h in global memory); times of the kernel, of the
    plain version and of the staged `A2C2f.forward` on the same weights
    (about 80 launches with the band attention kernel inside: the route the
    kernel replaces, and the yardstick, since no one PyTorch call computes
    the block)."""
    import torch
    from yolou_tpu_torch.kernels.a2c2f import (a2c2f_fused,
                                               a2c2f_fused_plain, f32_tile)
    f32_exact(torch)
    cases = [("L6@640", (BATCH, 40, 40, 128), 128, 2, 4, 2.0, BOTH),
             ("L8@640", (BATCH, 20, 20, 256), 256, 2, 1, 2.0, BOTH),
             ("small", (2, 16, 16, 64), 64, 1, 4, 2.0, BOTH),
             ("L6@640 mlp1.2", (BATCH, 40, 40, 128), 128, 2, 4, 1.2, BOTH),
             ("L8@640 mlp1.2", (BATCH, 20, 20, 256), 256, 2, 1, 1.2, BOTH),
             ("l L8@640", (BATCH, 20, 20, 512), 512, 4, 1, 2.0,
              ("float32",)),
             # one head of 48 (the fold pads it to 64), five stages
             ("A2C2f(96,96)", (BATCH, 20, 20, 96), 96, 1, 1, 2.0, BOTH),
             ("n5", (2, 20, 20, 128), 128, 5, 1, 2.0, BOTH),
             # an MLP too wide for the bf16 h tile (h in global memory):
             # A2C2f(512, 512, mlp_ratio=4.0), c_ 256
             ("mlp4", (1, 20, 20, 512), 512, 1, 1, 4.0, ("bfloat16",))]
    rng = np.random.default_rng(SEED + 6)
    results = {}
    for i, (name, shape, c2, n, area, mlp, dtypes) in enumerate(cases):
        module = seeded_a2c2f(shape[-1], c2, n, area, device, SEED + i, mlp)
        heads, c_ = module.num_heads, c2 // 2
        x = rng.normal(size=shape).astype(np.float32)
        for dtype in (getattr(torch, d) for d in dtypes):
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
            hid = ws[8].shape[1]
            nbytes, flops = a2c2f_work(shape, c_, c2, n, area,
                                       xt.element_size(), hid)
            tile = f32_tile(shape[0], shape[1] * shape[2] // area, area)
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
                mlp_width=hid, token_tile=tile,
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
    worst = {dn: max(r["max_abs_err"] for (_, d), r in results.items()
                     if d == dn) for dn in BOTH}
    return {"bfloat16": dict(results[("L6@640", "bfloat16")],
                             max_abs_err=worst["bfloat16"]),
            "float32": dict(results[("l L8@640", "float32")],
                            max_abs_err=worst["float32"]),
            "wide mlp": results[("mlp4", "bfloat16")]}


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
    # K = 2048, the most the kernel takes, against the plain version
    for name, boxes2 in _nms_cases(rng, BATCH, 4 * k):
        bt = torch.from_numpy(boxes2.astype(np.float32)).to(device)
        vt = torch.from_numpy(rng.random((BATCH, 4 * k)) < 0.9).to(device)
        keep = suppress_greedy(bt, vt, 0.45)
        ref = suppress_greedy_plain(bt, vt, 0.45)
        log("kernel", name="greedy_nms", case=f"{name} K=2048",
            shape=f"({BATCH},{4 * k})", kept=int(keep.sum()),
            mismatches=int((keep != ref).sum()),
            ms=kernel_times(lambda: suppress_greedy(bt, vt, 0.45))[0])
        if not torch.equal(keep, ref):
            raise AssertionError(f"greedy NMS {name} K=2048: keep-sets "
                                 f"differ")
    # the chain's own floor: no valid row, so no IoU test and every window
    # empty; one launch, the loads, the cluster barrier and the hops alone
    bt = torch.from_numpy(boxes[:BATCH].astype(np.float32)).to(device)
    vt = torch.zeros((BATCH, k), dtype=torch.bool, device=device)
    chain_floor_ms = kernel_times(lambda: suppress_greedy(bt, vt, 0.45))[0]
    if suppress_greedy(bt, vt, 0.45).any():
        raise AssertionError("greedy NMS kept a row of none valid")
    # a request of one image: B = 1, K = 512
    b1, v1 = bt[:1], torch.ones((1, k), dtype=torch.bool, device=device)
    keep1 = suppress_greedy(b1, v1, 0.45)
    if not torch.equal(keep1, suppress_greedy_plain(b1, v1, 0.45)):
        raise AssertionError("greedy NMS (1, 512): keep-sets differ")
    one_ms, one_call_ms = kernel_times(lambda: suppress_greedy(b1, v1, 0.45))
    log("kernel", name="greedy_nms", case="serve one image",
        shape=f"(1,{k})", kept=int(keep1.sum()), ms=one_ms,
        call_ms=one_call_ms,
        plain_ms=kernel_times(
            lambda: suppress_greedy_plain(b1, v1, 0.45))[0])
    # time at the serving shape: B = 8 images, K = 512 candidates
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
    # the chain: one owner CTA per 8 windows of 64 rows, a hop between
    # consecutive owners (mbarrier arrivals over distributed shared memory)
    hops = -(-k // 512) - 1
    log("kernel", name="greedy_nms", case="serve", shape=f"({BATCH},{k})",
        kept=int(keep.sum()), iou_tests=tests, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, chain_floor_ms=chain_floor_ms,
        chain_hops=hops, call_ms=call_ms,
        plain_call_ms=plain_call_ms)
    return {"max_abs_err": worst, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "chain_floor_ms": chain_floor_ms,
            "chain_hops": hops, "one_image_ms": one_ms}


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


def seeded_state_dict(arch: str = "yolov12", scale: str = "n",
                      device="cpu"):
    """`arch` `scale`-seg (4 ch, nc=1) weights from SEED: seeded random convs
    (drawn on the CPU, the same on every device);
    every BatchNorm calibrated by one f32 CPU pass over a seeded batch to
    output mean 0 and std BN_STD (its running statistics set to its batch's,
    its weight to BN_STD); then the warm-started head bias, so scores clear
    the confidence gate. Without the calibration the activations of a random
    init vanish within a few layers (empty masks); at std 1 the random
    network is chaotic (a 1e-6 input change moves boxes by pixels on the
    CPU), so no two devices could agree. At std 0.1 the same change moves
    boxes by < 1e-3 px and every image still gets detections with masks.
    The calibration pass runs on `device` (the card's in f32 without TF32
    for the larger scales, whose CPU pass would cost the phase seconds)."""
    import torch
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.ops.letterbox import letterbox_batch
    model = build_yolo(arch, scale, nc=1, ch=4, task="segment",
                       device=device, seed=SEED)
    calib = make_images(np.random.default_rng(SEED + 2), 2)
    x = letterbox_batch(torch.from_numpy(calib), (IMGSZ, IMGSZ))
    return calibrated(model, x.permute(0, 3, 1, 2).to(device))


def calibrated(model, x):
    """`model`'s state_dict after every BatchNorm is set to output mean 0
    and std BN_STD on the f32 batch `x` (NCHW in [0, 1]; see
    `seeded_state_dict`) and the head bias is warm-started."""
    import torch
    from torch import nn
    from yolou_tpu_torch.nn.heads import warm_start_detect_bias
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.fill_(BN_STD)
            bn.train()
            bn.momentum = 1.0
        model(x)
    for bn in bns:
        bn.eval()
        bn.momentum = 0.03
    return warm_start_detect_bias(model).state_dict()


def build_model(state_dict, device, dtype, mega_kernel=False,
                arch="yolov12", scale="n"):
    from yolou_tpu_torch.models.yolo import build_yolo
    model = build_yolo(arch, scale, nc=1, ch=4, task="segment",
                       dtype=dtype, device=device, mega_kernel=mega_kernel)
    model.load_state_dict(state_dict, strict=True)
    return model


def serve(state_dict, device, dtype, requests, mega_kernel=False,
          arch="yolov12", scale="n", imgsz=IMGSZ):
    """Drive the Predictor over `requests` (list of uint8 stacks); returns
    per-request detections and times."""
    import torch
    from yolou_tpu_torch.engine.predictor import Predictor
    predictor = Predictor(build_model(state_dict, device, dtype, mega_kernel,
                                      arch, scale),
                          imgsz=imgsz, batch_size=BATCH)
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


def compare_f32(state_dict, device, imgs, arch="yolov12", phase="serve",
                scale="n"):
    """Same weights and images in f32 on the card (no TF32) and on the CPU
    (plain kernel versions): preds, raw maps, mask coefficients and protos
    within 1e-3, and the kept anchors equal except where a candidate's score
    is within 1e-4 of another's; NMS on identical input keeps the same
    boxes on the card as the plain version."""
    import torch
    from yolou_tpu_torch.engine.predictor import Predictor
    from yolou_tpu_torch.ops.nms import (NMSResult, non_max_suppression,
                                         topk_stable)
    f32_exact(torch)
    outs = {}
    for dev in (device, "cpu"):
        p = Predictor(build_model(state_dict, dev, torch.float32,
                                  arch=arch, scale=scale), imgsz=IMGSZ)
        dets, out = p.infer(torch.from_numpy(imgs).to(dev))
        maps = [*out.raw, out.mask_coefs, out.protos]
        outs[dev] = (out.preds.cpu(), [t.cpu() for t in dets],
                     [t.float().cpu() for t in maps])
    (pg, dg, mg), (pc, dc, mc) = outs[device], outs["cpu"]
    err = (pg - pc).abs().max().item()
    maps_err = max((a - b).abs().max().item() for a, b in zip(mg, mc))
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
    log(phase, check="f32 card vs cpu", arch=arch, scale=scale,
        images=len(imgs),
        preds_max_abs=err, raw_coefs_protos_max_abs=maps_err,
        tol=1e-3, kept_agree=agree, differ_clear=clear_bad,
        differ_near_tie=tied_bad, nms_same_input_identical=ident)
    if not (err <= 1e-3 and maps_err <= 1e-3):
        raise AssertionError(f"f32 card vs cpu: preds {err}, raw maps, "
                             f"coefficients and protos {maps_err} > 1e-3")
    if clear_bad or not ident:
        raise AssertionError("f32 kept-box sets differ between card and cpu")
    return err


def compare_mega(state_dict, device, requests):
    """`mega_kernel=True` against the staged model on the same weights: the
    batch-8 bf16 forward timed in turns (staged, mega, mega, staged; CUDA
    events and a profiler window each), then f32 on the card, 2 images:
    preds within the tolerance `compare_f32` uses. Returns the forwards'
    wall (CUDA events) and device milliseconds."""
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
    return {"batch": BATCH, "mega_wall_ms": times[True],
            "mega_device_ms": prof[True][0], "staged_wall_ms": times[False],
            "staged_device_ms": prof[False][0]}


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


def build_evaluator(segpp_sd, device, dtype, mesh=None):
    """An Evaluator at 160^2, batch 16; `device` None is its default, the
    card (the mesh's device under `mesh`)."""
    from yolou_tpu_torch.engine.evaluator import Evaluator
    from yolou_tpu_torch.models.segpp import build_segpp
    model = build_segpp("yolov12", "n", nc=1, ch=4, task="segment",
                        dtype=dtype, device=device)
    model.load_state_dict(segpp_sd, strict=True)
    return Evaluator(model, data_root="", image_size=EVAL_IMGSZ,
                     batch_size=EVAL_BATCH, device=device, mesh=mesh)


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
    paths = {"bf16": kernels.path_counts()}
    log("evaluate", **res, launches=counts, steps=len(batches),
        band_attention_paths=paths["bf16"])
    want = {"band_attention": 8 * len(batches), "greedy_nms": len(batches)}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"evaluation launched {counts}, want {want}")
    if paths["bf16"] != {"short bf16": 8 * len(batches)}:
        raise AssertionError(f"evaluation's kernel A paths {paths['bf16']}")
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
        kernels.reset_launch_counts()
        with torch.no_grad():
            x = torch.from_numpy(imgs).to(dev).permute(0, 3, 1, 2)
            got[str(dev)] = (e32.model(x)[0].cpu(), e32.step(imgs)[0].cpu())
        if dev == device:
            paths["f32"] = kernels.path_counts()
            n32 = kernels.launch_counts()["band_attention"]
            if n32 < 8 or paths["f32"] != {"short f32": n32}:
                raise AssertionError(f"f32 evaluation step's kernel A "
                                     f"paths {paths['f32']}")
    (lg, bg), (lc, bc) = got[str(device)], got["cpu"]
    err = (lg - lc).abs().max().item()
    flipped = (bg != bc).float().mean().item()
    log("evaluate", check="f32 card vs cpu", images=len(imgs),
        mask_logits_max_abs=err, tol=1e-3, flipped_pixel_share=flipped,
        flipped_tol=1e-3, mask_share=bc.mean().item(),
        band_attention_paths=paths["f32"])
    if not (err <= 1e-3 and flipped <= 1e-3):
        raise AssertionError(f"f32 evaluation step card vs cpu: mask logits "
                             f"{err}, flipped pixels {flipped}")
    return counts, paths


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


def decoder_trainer(segpp_sd, device, dtype, datasets, run_dir, mesh=None,
                    **cfg):
    """A DecoderTrainer over YOLO-Seg++ with `segpp_sd`, its datasets the
    in-memory `datasets` (train, val); `device` None is its default, the
    card (the mesh's device under `mesh`)."""
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
    tr = DecoderTrainer(model, data_root="", cfg=cfg, device=device,
                        mesh=mesh)
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
        if not {"best.ckpt", "last.ckpt", "history.csv"} <= set(files):
            raise AssertionError(f"the run wrote {files}")

        # the run's last.ckpt in a fresh trainer: the same state, bit for
        # bit, and the same next step
        last = os.path.join(run, "weights", "last.ckpt")
        fresh = decoder_trainer(segpp_sd, None, torch.bfloat16, datasets,
                                os.path.join(run_dir, "c"))
        fresh.ensure_ready(DEC_SPLITS["train"] // DEC_BATCH)
        state_io = reload_check("train-decoder", tr, fresh, last, tr._save,
                                fresh.load_checkpoint)
        batch = next(data["train"].batches(DEC_BATCH, u8=True))[:3]
        # the run's cosine reaches 0 at its last update: lengthen both
        # schedules alike, so that the extra update moves the weights
        for t in (tr, fresh):
            t.ensure_ready(2 * DEC_SPLITS["train"] // DEC_BATCH)
        twin = twin_steps("train-decoder", tr, fresh,
                          lambda t: t.step(*batch)[0],
                          adamw_lr=tr.optimizer.param_groups[0]["lr"])

        tr2 = decoder_trainer(segpp_sd, None, torch.bfloat16, datasets,
                              os.path.join(run_dir, "b"),
                              epochs=DEC_EPOCHS + 1)
        h2 = tr2.train(resume_from=last)
        log("train-decoder", check="resume", epochs=len(h2["train_loss"]),
            steps=tr2.step_count, epoch_seconds=tr2.epoch_times, **h2)
        if len(h2["train_loss"]) != 1 or tr2.step_count != steps + 4:
            raise AssertionError(f"resume ran {len(h2['train_loss'])} "
                                 f"epochs to step {tr2.step_count}")
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
            "attention_backward_calls": calls,
            "training_state": dict(state_io, twin_step=twin)}


# ------------------------------------------------------------- training state

def state_differences(a, b) -> list:
    """Where two trainers' training states differ: every parameter and
    BatchNorm statistic, the EMA (detector), each parameter's optimizer
    state, the counters and the decoder's schedule. `num_batches_tracked`
    is left out: no training state holds it and the port's BatchNorm never
    reads it. Empty where the two are bit-identical."""
    import torch
    out = []
    sa, sb = a.model.state_dict(), b.model.state_dict()
    out += [k for k in sa if not k.endswith("num_batches_tracked")
            and not torch.equal(sa[k], sb[k])]
    out += [f"ema {i}" for i, (x, y) in enumerate(zip(
        getattr(a, "ema_params", None) or [],
        getattr(b, "ema_params", None) or [])) if not torch.equal(x, y)]
    pb = dict(b.model.named_parameters())
    for name, p in a.model.named_parameters():
        x, y = a.optimizer.state.get(p, {}), b.optimizer.state.get(pb[name], {})
        if set(x) != set(y):
            out.append(f"optimizer {name}: {sorted(x)} / {sorted(y)}")
            continue
        out += [f"optimizer {name} {k}" for k in x
                if not torch.equal(x[k].cpu(), y[k].cpu())]
    for c in ("step_count", "opt_count", "_notfinite", "total_notfinite",
              "last_finite"):
        if getattr(a, c, None) != getattr(b, c, None):
            out.append(f"{c}: {getattr(a, c, None)} / {getattr(b, c, None)}")
    if getattr(a, "scheduler", None) is not None and (
            a.scheduler.last_epoch != b.scheduler.last_epoch
            or a.optimizer.param_groups[0]["lr"]
            != b.optimizer.param_groups[0]["lr"]):
        out.append("schedule")
    return out


def reload_check(phase: str, tr, fresh, path: str, save, load) -> dict:
    """`path` (the run's `last.ckpt`) read into the `fresh` trainer (its
    optimizer built) must give `tr`'s state bit for bit; the state written
    again by `save` must be `path`'s bytes. Logs the bytes and the write
    and read seconds (host clock) beside the card."""
    import os
    again = path + ".again"
    t0 = time.perf_counter()
    save(again)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load(path)
    read_s = time.perf_counter() - t0
    with open(path, "rb") as f, open(again, "rb") as g:
        same_bytes = f.read() == g.read()
    os.remove(again)
    diffs = state_differences(tr, fresh)
    out = {"bytes": os.path.getsize(path), "write_s": write_s,
           "read_s": read_s}
    log(phase, check="training state", **out, rewrite_same_bytes=same_bytes,
        bit_identical=not diffs, differences=diffs[:5], card=card_line())
    if diffs or not same_bytes:
        raise AssertionError(f"{phase}: the reloaded state differs: "
                             f"{diffs[:5]}, same bytes {same_bytes}")
    return out


def twin_steps(phase: str, a, b, step, adamw_lr=None) -> dict:
    """One more step on trainers `a` and `b`, which hold the same state,
    by `step(trainer)` (the same batch and generator state for each), with
    cuDNN's deterministic algorithms on and torch's deterministic mode in
    its warning form. Bit-identical where every kernel of the step is
    deterministic; else the losses within 1e-3 relative and each updated
    parameter within 2 % of the step's largest update (for AdamW, whose
    update is about lr an element whatever the gradient, every element
    within 2 lr and all but 0.5 % within that 2 %). Logs the ops that have
    no deterministic form."""
    import warnings
    import torch
    before = [p.detach().clone() for p in a.model.parameters()]
    mode = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.deterministic = True
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            la, lb = float(step(a)), float(step(b))
            torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(mode[0], warn_only=mode[1])
        torch.backends.cudnn.deterministic = mode[2]
    ops = sorted({str(w.message).split(" does not have")[0]
                  for w in caught if "deterministic" in str(w.message)})
    upd = max(float((p.detach() - q).abs().max())
              for p, q in zip(a.model.parameters(), before))
    d = torch.cat([(p.detach() - q.detach()).abs().flatten() for p, q in
                   zip(a.model.parameters(), b.model.parameters())])
    diff, far = float(d.max()), float((d > 0.02 * upd).float().mean())
    diffs = state_differences(a, b)
    out = {"loss": [la, lb], "bit_identical": not diffs and la == lb,
           "max_update": upd, "max_param_diff": diff,
           "share_past_2pc": far, "nondeterministic_ops": ops}
    log(phase, check="one more step on both", **out)
    if not out["bit_identical"]:
        ok = abs(la - lb) <= 1e-3 * abs(la)
        if adamw_lr is None:
            ok = ok and diff <= 0.02 * upd
        else:
            ok = ok and diff <= 2 * adamw_lr and far <= 5e-3
        if not ok:
            raise AssertionError(f"{phase}: the two trainers parted: {out}")
    return out


# ------------------------------------------------------------- training

class _Data:
    """The fields of a data config the trainer reads in `step`."""
    channels = 4


def make_trainer(state_dict, device, dtype, batch, aug=None,
                 arch="yolov12", mesh=None, imgsz=IMGSZ):
    """A DetectorTrainer over seeded `arch` n-seg weights; `device` None is
    the trainer's default, the card (the mesh's device under `mesh`)."""
    from yolou_tpu_torch.data.augment import AugHyp
    from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                         DetectorTrainer)
    from yolou_tpu_torch.models.yolo import build_yolo
    model = build_yolo(arch, "n", nc=1, ch=4, task="segment",
                       dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)
    cfg = DetectorTrainConfig(imgsz=imgsz, batch_size=batch, epochs=10,
                              warmup_epochs=3.0)
    tr = DetectorTrainer(model, _Data(), cfg, aug=aug or AugHyp(),
                         device=device, mesh=mesh)
    tr.ensure_ready(steps_per_epoch=100)
    return tr


def train(state_dict, arch="yolov12"):
    """TRAIN_STEPS steps of the detector trainer on the card, bf16, 640^2,
    batch 8, mosaic on; returns the per-step statistics and what it drove,
    for `train_breakdown`."""
    import torch
    tr = make_trainer(state_dict, None, torch.bfloat16, BATCH, arch=arch)
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


def compare_train_f32(state_dict, device, imgsz=IMGSZ, phase="train"):
    """One f32 step at `imgsz`, batch 2, augmentation off, same weights and
    batch, on the card (the kernel, no TF32) and on the CPU (the plain
    version): loss and global gradient norm (before clipping) within 1e-3
    relative. Returns the card's step's launches and kernel C's backward
    calls (the CPU's step counts backward calls too)."""
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.data.augment import AugHyp
    f32_exact(torch)
    off = AugHyp(mosaic=0.0, translate=0.0, scale=0.0, fliplr=0.0, hsv_h=0.0,
                 hsv_s=0.0, hsv_v=0.0, noise_p=0.0, blur_p=0.0, bias_p=0.0)
    batch = make_labelled(np.random.default_rng(SEED + 5), 2, imgsz)
    got = {}
    for dev in (device, "cpu"):
        tr = make_trainer(state_dict, dev, torch.float32, 2, aug=off,
                          imgsz=imgsz)
        gen = torch.Generator(device=tr.device).manual_seed(SEED)
        kernels.reset_launch_counts()
        loss, _ = tr.step(batch, gen, use_mosaic=False)
        got[str(dev)] = (loss.item(), tr.grad_norm.item())
        if dev is device:
            card = dict(kernels.launch_counts(), backward=kernels.
                        backward_counts()["band_attention_train"])
    (lg, ng), (lc, nc_) = got[str(device)], got["cpu"]
    rel_loss, rel_norm = abs(lg - lc) / abs(lc), abs(ng - nc_) / abs(nc_)
    log(phase, check="f32 card vs cpu", batch=2, imgsz=imgsz,
        loss_card=lg, loss_cpu=lc,
        loss_rel=rel_loss, grad_norm_card=ng, grad_norm_cpu=nc_,
        grad_norm_rel=rel_norm, tol=1e-3)
    if not (rel_loss <= 1e-3 and rel_norm <= 1e-3):
        raise AssertionError(f"f32 training step card vs cpu: loss "
                             f"{rel_loss}, gradient norm {rel_norm} > 1e-3")
    return card


# ------------------------------------------------- shapes past yolov12n@640

@contextlib.contextmanager
def plain_attention():
    """The attention modules of `nn/attention.py` on the kernels' plain
    versions, on any device, while the block runs: the reference a module
    is held against on the card."""
    from yolou_tpu_torch.kernels import attention as ka
    from yolou_tpu_torch.nn import attention as na
    saved = na.area_attention_qkv_fused, na.area_attention_fused
    na.area_attention_qkv_fused = ka.area_attention_qkv_fused_plain
    na.area_attention_fused = ka.area_attention_fused_plain
    try:
        yield
    finally:
        na.area_attention_qkv_fused, na.area_attention_fused = saved


def residual_block_check(device) -> dict:
    """A residual A2C2f (128 -> 128, n 2, area 4, mlp_ratio 1.2; gamma
    seeded near 0.5) at (8, 128, 40, 40): bf16 eval (4 kernel A launches)
    and f32 train forward and backward (4 kernel C launches, 4 backward
    calls), each against the same module on the plain versions: bf16 within
    twice `check_a2c2f`'s staged bound, f32 outputs and input and gamma
    gradients within 1e-4 of their largest magnitude."""
    import copy
    import torch
    from yolou_tpu_torch import kernels
    block = seeded_a2c2f(128, 128, 2, 4, device, SEED + 50, 1.2,
                         residual=True)
    gen = torch.Generator().manual_seed(SEED + 51)
    with torch.no_grad():
        block.gamma.copy_(0.5 + 0.1 * torch.randn(128, generator=gen))
    rng = np.random.default_rng(SEED + 52)
    x = torch.from_numpy(rng.normal(size=(BATCH, 128, 40, 40)).astype(
        np.float32)).to(device)
    w = torch.from_numpy(rng.normal(size=(BATCH, 128, 40, 40)).astype(
        np.float32)).to(device)
    out = {}
    bf = copy.deepcopy(block)       # f32 parameters, bf16 compute (the port's)
    xb = x.to(torch.bfloat16)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = bf(xb)
        out["eval"] = counts = dict(kernels.launch_counts())
        with plain_attention():
            want = bf(xb)
    check_launches("residual A2C2f bf16 eval", counts, 4, 0)
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    tol = 2 * min(ATTN_TOL["bfloat16"], 2.0 ** -6 * top)

    def train_pass(module):
        xt = x.clone().requires_grad_()
        y = module.train()(xt)
        (y * w).sum().backward()
        return y.detach(), xt.grad, module.gamma.grad

    kernels.reset_launch_counts()
    got_t = train_pass(copy.deepcopy(block))
    out["train"] = tcounts = dict(
        kernels.launch_counts(),
        backward=kernels.backward_counts()["band_attention_train"])
    with plain_attention():
        want_t = train_pass(copy.deepcopy(block))
    check_launches("residual A2C2f f32 train", tcounts, 0, 0,
                   band_attention_train=4, backward=4)
    errs = [((a - b).abs().max() / b.abs().max()).item()
            for a, b in zip(got_t, want_t)]
    log("shapes", check="residual A2C2f", shape=tuple(x.shape),
        bf16_eval_max_abs=err, bf16_tol=tol, bf16_out_abs_max=top,
        f32_train_rel=dict(zip(("out", "dx", "dgamma"), errs)),
        f32_tol_rel=1e-4, launches=out)
    if not (torch.isfinite(got).all() and err <= tol and max(errs) <= 1e-4):
        raise AssertionError(f"residual A2C2f: bf16 {err} (tol {tol}), f32 "
                             f"train {errs} (tol 1e-4 relative)")
    return out


def wide_shapes_check(device) -> dict:
    """Modules whose shapes the port refused on the card before kernel A's
    wide form and the bf16 `a2c2f` with h in global memory, each through
    its module's forward at (1, C, 40, 40) (area 4: bands of 400) or 20^2,
    seeded: A2C2f(1856, 1856, area=4) staged in bf16 and f32 (c_ 928 in 29
    heads, 2 launches: bf16 kernel A's wide form; f32 its streamed path,
    whose q-projecting kernel fits up to 1343 channels), AAttn(512, 8) in
    bf16 and AAttn(640, 10) in f32 (heads of 64: the wide form, 1 launch),
    each against the same module on the plain versions (`plain_attention`);
    and
    A2C2f(512, 512, mlp_ratio=4.0) in bf16 through `mega_kernel` (one
    `a2c2f` launch, no kernel A) against the staged module (2 streamed
    kernel A launches); and heads wider than 64, which the port refused on
    the card before the blocked path (`heads_wider_than_64`). Tolerances:
    bf16 twice `check_a2c2f`'s (2e-2 and 2**-6 of the largest output), f32
    1e-4. Returns each check's launches and kernel A's paths."""
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.nn.attention import AAttn
    rng = np.random.default_rng(SEED + 60)
    out = {}

    def run(name, module, shape, dtype, paths, **launches):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, dtype)
        kernels.reset_launch_counts()
        with torch.no_grad():
            got = module(x)
            counts = dict(kernels.launch_counts())
            got_paths = kernels.path_counts()
            with plain_attention():
                want = module(x)
        top = want.float().abs().max().item()
        tol = (ATTN_TOL["float32"] if dtype == torch.float32
               else 2 * min(ATTN_TOL["bfloat16"], 2.0 ** -6 * top))
        err = (got.float() - want.float()).abs().max().item()
        out[name] = {**counts, "paths": got_paths}
        log("shapes", check=name, shape=shape, dtype=dtype_name(dtype),
            max_abs=err, tol=tol, out_abs_max=top, launches=counts,
            paths=got_paths)
        check_launches(name, counts, launches.get("band_attention", 0), 0,
                       a2c2f=launches.get("a2c2f", 0))
        if got_paths != paths:
            raise AssertionError(f"{name}: kernel A's paths {got_paths}, "
                                 f"want {paths}")
        if not (torch.isfinite(got).all() and err <= tol and top > 0.05):
            raise AssertionError(f"{name}: {err} (tol {tol}, largest "
                                 f"output {top})")

    out.update(heads_wider_than_64(device, run))
    # f32 fits kernel A's q-projecting kernel at 928 channels (to 1343)
    block = seeded_a2c2f(1856, 1856, 1, 4, device, SEED + 61)
    for dtype, path in ((torch.bfloat16, "wide bf16"),
                        (torch.float32, "streamed f32")):
        run(f"A2C2f(1856,1856) {dtype_name(dtype)}", block,
            (1, 1856, 40, 40), dtype, {path: 2}, band_attention=2)
    del block
    run("AAttn(512,8) bf16", seeded_module(AAttn(512, 8, 4), device,
                                           SEED + 62),
        (1, 512, 40, 40), torch.bfloat16, {"wide bf16": 1}, band_attention=1)
    run("AAttn(640,10) f32", seeded_module(AAttn(640, 10, 4), device,
                                           SEED + 63),
        (1, 640, 40, 40), torch.float32, {"wide f32": 1}, band_attention=1)

    block = seeded_a2c2f(512, 512, 1, 1, device, SEED + 64, 4.0)
    block.mega_kernel = True
    x = torch.from_numpy(rng.normal(size=(1, 512, 20, 20)).astype(
        np.float32)).to(device, torch.bfloat16)
    with torch.no_grad():
        kernels.reset_launch_counts()
        got = block(x)
        counts = dict(kernels.launch_counts())
        block.mega_kernel = False
        kernels.reset_launch_counts()
        want = block(x)
        staged = dict(kernels.launch_counts())
        staged_paths = kernels.path_counts()
    top = want.float().abs().max().item()
    tol = 2 * min(ATTN_TOL["bfloat16"], 2.0 ** -6 * top)
    err = (got.float() - want.float()).abs().max().item()
    out["A2C2f(512,512) mlp4 mega"] = counts
    log("shapes", check="A2C2f(512,512) mlp_ratio 4.0 bf16 mega vs staged",
        max_abs=err, tol=tol, out_abs_max=top, launches=counts,
        staged_launches=staged, staged_paths=staged_paths)
    check_launches("A2C2f mlp4 mega", counts, 0, 0, a2c2f=1)
    check_launches("A2C2f mlp4 staged", staged, 2, 0)
    if staged_paths != {"streamed bf16": 2}:
        raise AssertionError(f"A2C2f mlp4 staged: paths {staged_paths}")
    if not (torch.isfinite(got).all() and err <= tol and top > 0.05):
        raise AssertionError(f"A2C2f mlp4 mega vs staged: {err} (tol {tol})")
    return out


def heads_wider_than_64(device, run) -> dict:
    """Heads the port refused on the card before the blocked path, seeded:
    AAttn(256, 2, 4) (heads of 128) at (1, 256, 40, 40), 20^2 and 10^2
    (bands of 400, 100 and 25) in bf16 and f32, eval through
    `wide_shapes_check`'s `run` (one kernel A launch on path "blocked") and
    train mode forward and backward (one kernel C launch on path "blocked",
    one backward call), against the same module on the plain versions:
    outputs within `run`'s tolerances, the input's gradient within GRAD_TOL
    of its largest magnitude (the cotangent is N(0, 1)); the same train runs
    of AAttn(96, 2, 4) at 20^2 and 10^2 and AAttn(192, 2, 4) at 20^2 (heads
    of 48 and 96, which kernel C pads inside the kernel: paths "streamed",
    "short" and "blocked <type> padded"); AAttn(512, 1, 4)
    (one head of 512) in bf16 eval at 40^2; and `a2c2f_fused` over an A2C2f
    fold of c_ 256 in two heads (of 128) and of c_ 96 in one (padded to
    128) at (8, 20, 20, 2 c_), both types, one launch each, against its
    plain version (`check_a2c2f`'s tolerances). Returns each check's
    launches and paths, and under "a2c2f <dtype>" the c_ 256 case timed."""
    import copy
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused, a2c2f_fused_plain
    from yolou_tpu_torch.nn.attention import AAttn
    rng = np.random.default_rng(SEED + 70)
    out = {}

    def train_run(name, module, shape, dtype, path="blocked"):
        x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            device, dtype)
        cot = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)

        def train_pass(m):
            xt = x.clone().requires_grad_()
            y = m.train()(xt)
            (y.float() * cot).sum().backward()
            return y.detach().float(), xt.grad.float()

        kernels.reset_launch_counts()
        got = train_pass(copy.deepcopy(module))
        counts = dict(kernels.launch_counts(), backward=kernels.
                      backward_counts()["band_attention_train"])
        paths = kernels.path_counts("band_attention_train")
        with plain_attention():
            want = train_pass(copy.deepcopy(module))
        dn = dtype_name(dtype)
        top = want[0].abs().max().item()
        tol = (ATTN_TOL[dn] if dtype == torch.float32
               else 2 * min(ATTN_TOL[dn], 2.0 ** -6 * top))
        err = (got[0] - want[0]).abs().max().item()
        gerr = ((got[1] - want[1]).abs().max()
                / want[1].abs().max()).item()
        out[name] = {**counts, "paths": paths}
        log("shapes", check=name, shape=shape, dtype=dn, max_abs=err,
            tol=tol, out_abs_max=top, grad_rel=gerr, grad_tol=GRAD_TOL[dn],
            launches=counts, paths=paths)
        check_launches(name, counts, 0, 0, band_attention_train=1,
                       backward=1)
        if paths != {path.replace("<type>", SHORT[dn]): 1}:
            raise AssertionError(f"{name}: kernel C's paths {paths}")
        if not (torch.isfinite(got[0]).all() and err <= tol
                and gerr <= GRAD_TOL[dn] and top > 0.05):
            raise AssertionError(f"{name}: {err} (tol {tol}), gradient "
                                 f"{gerr} (tol {GRAD_TOL[dn]})")

    aattn = seeded_module(AAttn(256, 2, 4), device, SEED + 71)
    for dtype in (torch.bfloat16, torch.float32):
        path = {f"blocked {SHORT[dtype_name(dtype)]}": 1}
        for hw in (40, 20, 10):
            name = f"AAttn(256,2) {hw}^2 {dtype_name(dtype)}"
            run(name, aattn, (1, 256, hw, hw), dtype, path, band_attention=1)
            train_run(f"{name} train", aattn, (1, 256, hw, hw), dtype,
                      "blocked <type>")
    # heads of 48 (bands of 100 and 25) and of 96, padded inside kernel C
    for c, hws in ((96, (20, 10)), (192, (20,))):
        module = seeded_module(AAttn(c, 2, 4), device, SEED + 74 + c)
        for dtype in (torch.bfloat16, torch.float32):
            for hw in hws:
                path = ("blocked" if c == 192 else
                        "short" if hw == 10 else "streamed")
                train_run(f"AAttn({c},2) {hw}^2 {dtype_name(dtype)} train",
                          module, (1, c, hw, hw), dtype,
                          f"{path} <type> padded")
    run("AAttn(512,1) bf16", seeded_module(AAttn(512, 1, 4), device,
                                           SEED + 72),
        (1, 512, 40, 40), torch.bfloat16, {"blocked bf16": 1},
        band_attention=1)

    for c_, heads in ((256, 2), (96, 1)):
        block = seeded_a2c2f(2 * c_, 2 * c_, 1, 1, device, SEED + 73 + c_)
        block.num_heads = heads          # the fold pads to this head count
        x = rng.normal(size=(8, 20, 20, 2 * c_)).astype(np.float32)
        for dtype in (torch.bfloat16, torch.float32):
            dn = dtype_name(dtype)
            name = f"a2c2f c_{c_} h{heads} {dn}"
            xt = torch.from_numpy(x).to(device, dtype)
            with torch.no_grad():
                ws = block.folded_weights(dtype)
                kernels.reset_launch_counts()
                got = a2c2f_fused(xt, ws, 1, 1, heads)
                counts = dict(kernels.launch_counts())
                want = a2c2f_fused_plain(xt, ws, 1, 1, heads)
            top = want.float().abs().max().item()
            tol = (ATTN_TOL[dn] if dtype == torch.float32
                   else min(ATTN_TOL[dn], 2.0 ** -6 * top))
            err = (got.float() - want.float()).abs().max().item()
            check_launches(name, counts, 0, 0, a2c2f=1)
            row = {"launches": counts["a2c2f"], "max_abs_err": err,
                   "tol": tol, "attention_width": ws[2].shape[1] // 3}
            if c_ == 256:
                with torch.no_grad():
                    ms, call_ms = kernel_times(
                        lambda: a2c2f_fused(xt, ws, 1, 1, heads))
                    plain_ms = kernel_times(
                        lambda: a2c2f_fused_plain(xt, ws, 1, 1, heads))[0]
                nbytes, flops = a2c2f_work(
                    x.shape, c_, 2 * c_, 1, 1, xt.element_size(),
                    ws[8].shape[1])
                bound_ms, bound_by = bound(nbytes, flops, dn)
                row.update(ms=ms, call_ms=call_ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
                out[f"a2c2f {dn}"] = row
            log("shapes", check=name, out_abs_max=top, **row)
            out[name] = counts
            if not (torch.isfinite(got).all() and err <= tol and top > 0.05):
                raise AssertionError(f"{name}: {err} (tol {tol})")
    return out


def raw_forward_finite(state_dict, device, imgs, scale, imgsz) -> None:
    """The bf16 forward of `imgs` (letterbox to `imgsz`, no NMS) through
    `Predictor.infer`: raw maps, mask coefficients and protos finite."""
    import torch
    from yolou_tpu_torch.engine.predictor import Predictor
    p = Predictor(build_model(state_dict, device, torch.bfloat16,
                              scale=scale), imgsz=imgsz)
    with torch.no_grad():
        _, out = p.infer(torch.from_numpy(imgs).to(device))
    maps = [out.preds, *out.raw, out.mask_coefs, out.protos]
    finite = all(bool(torch.isfinite(t).all()) for t in maps)
    log("shapes", check=f"bf16 {imgsz}^2 raw forward finite", finite=finite,
        shapes=[tuple(t.shape) for t in maps])
    if not finite:
        raise AssertionError(f"bf16 forward at {imgsz}^2: non-finite output")


def shapes_phase(device, state_dict) -> dict:
    """The shapes past yolov12n at 640^2 and the MLP width, through the
    entry points: (a) a Predictor with seeded, calibrated yolov12s-seg
    weights serving 2 requests of 8 at 640^2 in f32 (8 kernel A launches a
    forward, on the streamed path, as every band past 64 tokens; a
    detection on every image), then f32 card vs CPU as `compare_f32`; (b)
    the same weights serving a request of 8 at 1280^2 in bf16 (both layers'
    bands of 1600 tokens; a detection on every image, and its raw
    forward on those images finite); (c) one f32 DetectorTrainer step of
    yolov12n (`state_dict`) at 1024^2, batch 2, card vs CPU as the train
    phase (kernel C streamed, 8 launches and 8 backward calls); (d) yolov12l at 640^2, f32, batch 2,
    with mega_kernel: one a2c2f launch a forward (layer 8 on the f32 token
    tile of 8; layer 6's 16 ABlocks through kernel A), within 1e-3 of the
    flag off; (e) `residual_block_check`; (f) `wide_shapes_check`. Returns
    each part's launches, and under "device kernels" kernel A's device
    kernels in (a) and (b)."""
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.ops.letterbox import letterbox_batch
    f32_exact(torch)
    rng = np.random.default_rng(SEED + 40)
    out = {}
    sd_s = seeded_state_dict(scale="s", device=device)
    requests = [make_images(rng, BATCH) for _ in range(2)]
    devices = out["device kernels"] = {}
    kernels.reset_launch_counts()
    stats = serve(sd_s, device, torch.float32, requests, scale="s")
    out["yolov12s f32 640"] = counts = dict(kernels.launch_counts())
    devices["yolov12s f32 640"] = kernels.device_counts()["band_attention"]
    out["kernel A paths"] = {"yolov12s f32 640": kernels.path_counts()}
    for st in stats:
        log("shapes", serve="yolov12s f32 640^2", **st)
    check_launches("yolov12s f32 640^2", counts, 8 * len(requests),
                   len(requests))
    if min(min(st["detections"]) for st in stats) < 1:
        raise AssertionError("yolov12s f32: an image got no detection")
    compare_f32(sd_s, device, requests[0][:2], phase="shapes", scale="s")

    big = [make_images(rng, BATCH, 1280)]
    kernels.reset_launch_counts()
    stats = serve(sd_s, device, torch.bfloat16, big, scale="s", imgsz=1280)
    out["yolov12s bf16 1280"] = counts = dict(kernels.launch_counts())
    devices["yolov12s bf16 1280"] = kernels.device_counts()["band_attention"]
    log("shapes", serve="yolov12s bf16 1280^2", **stats[0],
        band_attention_device_kernels=devices)
    check_launches("yolov12s bf16 1280^2", counts, 8, 1)
    if min(stats[0]["detections"]) < 1:
        raise AssertionError("yolov12s bf16 1280^2: an image got no "
                             "detection")
    raw_forward_finite(sd_s, device, big[0], "s", 1280)

    out["yolov12n train f32 1024"] = counts = compare_train_f32(
        state_dict, device, imgsz=1024, phase="shapes")
    check_launches("yolov12n f32 step at 1024^2", counts, 0, 0,
                   band_attention_train=8, backward=8)

    sd_l = seeded_state_dict(scale="l", device=device)
    imgs = torch.from_numpy(make_images(rng, 2)).to(device)
    x = letterbox_batch(imgs, (IMGSZ, IMGSZ)).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        mega = build_model(sd_l, device, torch.float32, True, scale="l")
        kernels.reset_launch_counts()
        got = mega(x).preds
        out["yolov12l mega f32 640"] = counts = dict(kernels.launch_counts())
        want = build_model(sd_l, device, torch.float32, False,
                           scale="l")(x).preds
    err = (got - want).abs().max().item()
    log("shapes", check="yolov12l f32 mega vs staged", images=2,
        preds_max_abs=err, tol=1e-3, launches=counts)
    check_launches("yolov12l mega f32", counts, 8, 0, a2c2f=1)
    if not err <= 1e-3:
        raise AssertionError(f"yolov12l f32 mega vs staged: {err} > 1e-3")
    out["residual"] = residual_block_check(device)
    out["wide"] = wide_shapes_check(device)
    return out


# ------------------------------------------------------- detector fine-tune

FT_SPLITS = {"train": 128, "val": 64}
FT_EPOCHS = 3
FT_STEPS = FT_SPLITS["train"] // EVAL_BATCH          # steps an epoch
FT_VAL_BATCHES = FT_SPLITS["val"] // EVAL_BATCH      # batches a validation


class MemoryDetData:
    """A detector split held in memory (no files, no cv2), from
    `make_labelled`'s arrays, with the methods the trainer reads
    (`load_image`, `item_idmap`, `imgsz`, `channels`) and the validator's
    (`item`, `orig_shape`); every ellipse is class 0."""

    def __init__(self, imgs, idmap, cls, valid):
        self.imgs, self.idmap, self.valid = imgs, idmap, valid
        self.imgsz, self.channels = imgs.shape[1], imgs.shape[3]
        self.slots = [int(m.max()) for m in idmap]

    def __len__(self):
        return len(self.imgs)

    def load_image(self, i):
        return self.imgs[i]

    def item_idmap(self, i):
        n = self.slots[i]
        return self.idmap[i], np.zeros(n, np.int32), self.valid[i, :n]

    def orig_shape(self, i):
        return self.imgs.shape[1:3]

    def item(self, i):
        ids = np.arange(1, self.slots[i] + 1)[:, None, None]
        return {"img": self.imgs[i],
                "masks": (self.idmap[i][None] == ids).astype(np.uint8),
                "cls": np.zeros(len(ids), np.int32)}


def inflated_state_dict(calib):
    """The reference's step 1: seeded yolov12n-seg weights built with a
    3-channel stem, inflated to 4 channels by `inflate_stem_to_4ch` (the
    fourth input channel the mean of the RGB kernels), then calibrated
    (`calibrated`) on the uint8 batch `calib` at its size."""
    import torch
    from yolou_tpu_torch.models.yolo import build_yolo, inflate_stem_to_4ch
    three = build_yolo("yolov12", "n", nc=1, ch=3, task="segment",
                       device="cpu", seed=SEED)
    sd = inflate_stem_to_4ch(three.state_dict())
    w = sd["model.0.conv.weight"]
    mean = (w[:, 0] + w[:, 1] + w[:, 2]) * (1 / 3)
    if w.shape[1] != 4 or not torch.equal(w[:, 3], mean):
        raise AssertionError(f"stem inflation gave {tuple(w.shape)}")
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(calib).permute(0, 3, 1, 2).float() / 255.0
    return calibrated(model, x)


def ft_trainer(state_dict, device, dtype, data, run_dir, epochs):
    """A DetectorTrainer in the reference's fine-tune configuration (160^2,
    batch 16, validation every epoch, close_mosaic 1) over the in-memory
    `data` (train, val); `device` None is its default, the card."""
    from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                         DetectorTrainer)
    from yolou_tpu_torch.models.yolo import build_yolo
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)
    cfg = DetectorTrainConfig(imgsz=EVAL_IMGSZ, batch_size=EVAL_BATCH,
                              epochs=epochs, close_mosaic=1, val_every=1,
                              warmup_epochs=1.0, run_dir=run_dir)
    tr = DetectorTrainer(model, _Data(), cfg, device=device)
    tr._datasets = lambda: data
    return tr


def watch_validations(tr):
    """Wrap `tr.validate`: each call must leave the training model's mode
    and BatchNorm statistics as they were; returns the list that collects
    each validation's kernel launches."""
    import torch
    from yolou_tpu_torch import kernels
    real, seen = tr.validate, []

    def validate(val_ds):
        mode = [m.training for m in tr.model.modules()]
        stats = {k: v.clone() for k, v in tr.model.state_dict().items()
                 if "running_" in k}
        before = kernels.launch_counts()
        out = real(val_ds)
        after = kernels.launch_counts()
        seen.append({k: after[k] - before[k] for k in after})
        now = tr.model.state_dict()
        if ([m.training for m in tr.model.modules()] != mode
                or not all(torch.equal(now[k], v) for k, v in stats.items())):
            raise AssertionError("a validation changed the training model")
        return out

    tr.validate = validate
    return seen


def validation_breakdown(model, data, iters: int = 3):
    """The parts of a validation batch (batch 16, 160^2) through the
    validator's own parts, as `validate_detector` runs them, means over the
    split's batches and `iters` passes after one: upload, forward, NMS and
    the device-to-host copy by CUDA events that `detect_batch` records
    after each part; the host's collate (`validation_batches`) and its box
    matching + AP (`score_batch` per batch and `DetMetrics.compute` once per
    pass, shared out over the batches) by the host clock."""
    import torch
    from yolou_tpu_torch.engine.validator import (detect_batch, score_batch,
                                                   validation_batches)
    from yolou_tpu_torch.metrics.det import DetMetrics
    names = ("upload", "forward", "nms", "d2h")
    sums = dict.fromkeys(names + ("collate", "match_ap"), 0.0)
    n_det, n_batches = 0, -(-len(data) // EVAL_BATCH)
    model.eval()
    for it in range(iters + 1):
        metrics = DetMetrics(nc=model.spec.nc)
        host = {"collate": 0.0, "match_ap": 0.0}
        batches = validation_batches(data, imgsz=EVAL_IMGSZ,
                                     batch_size=EVAL_BATCH, max_inst=16,
                                     rect=False, stride=32)
        while True:
            t0 = time.perf_counter()
            got = next(batches, None)
            host["collate"] += time.perf_counter() - t0
            if got is None:
                break
            n, hw, batch = got
            e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
            e[0].record()
            marks = iter(e[1:])
            dets = detect_batch(model, batch["img"], conf=0.001, iou=0.45,
                                max_det=300, mark=lambda: next(marks).record())
            t0 = time.perf_counter()
            score_batch(metrics, dets, batch, n, hw)
            host["match_ap"] += time.perf_counter() - t0
            n_det += int(dets[:n, :, 6].sum()) * (it > 0)
            if it:
                for name, a, b in zip(names, e, e[1:]):
                    sums[name] += a.elapsed_time(b) / iters / n_batches
        t0 = time.perf_counter()
        metrics.compute()
        host["match_ap"] += time.perf_counter() - t0
        if it:
            for k, v in host.items():
                sums[k] += v * 1e3 / iters / n_batches
    out = {f"{k}_ms": v for k, v in sums.items()}
    out["detections_per_image"] = n_det / iters / len(data)
    return out


def flipped_detections(card, cpu, iou_thres=0.45, conf_thres=0.001,
                       tol=1e-4):
    """The detections one device kept and the other did not, per image of
    two (B, max_det, 7) validation outputs (a kept box of one device with no
    box of IoU > 0.99 among the other's): (image, device that kept it, the
    decision it lies nearest, gap). Greedy NMS drops a box through a kept
    box of higher rank with IoU > iou_thres: on the device that dropped it
    that is the kept box of largest IoU. Where that IoU is above iou_thres
    and the two scores lie within `tol`, the decision is their rank (scores
    saturated at 1.0 are ranked by rounding) and the gap is the score
    difference; otherwise it is the nearer of the IoU's distance to
    iou_thres and the dropped box's score's distance to conf_thres (the
    gate)."""
    from yolou_tpu_torch.metrics.det import box_iou_np
    out = []
    for i in range(len(card)):
        sides = {"card": card[i][card[i][:, 6] > 0],
                 "cpu": cpu[i][cpu[i][:, 6] > 0]}
        for name, other in (("card", "cpu"), ("cpu", "card")):
            mine, theirs = sides[name], sides[other]
            iou = box_iou_np(mine[:, :4].astype(np.float64),
                             theirs[:, :4].astype(np.float64))
            if not iou.shape[1]:
                iou = np.zeros((len(mine), 1))
                theirs = np.zeros((1, 7))
            for j in np.nonzero(iou.max(1) <= 0.99)[0]:
                k = iou[j].argmax()
                rank = float(theirs[k, 4]) - float(mine[j, 4])
                if iou[j, k] > iou_thres and abs(rank) <= tol:
                    out.append((i, name, "rank", rank))
                    continue
                gaps = {"iou": iou[j, k] - iou_thres,
                        "gate": float(mine[j, 4]) - conf_thres}
                kind = min(gaps, key=lambda g: abs(gaps[g]))
                out.append((i, name, kind, gaps[kind]))
    return out


def compare_validation_f32(weights, data, what, near_ties):
    """`weights` in f32 validated on the card (TF32 off) and on the CPU over
    the same split: metrics within 1e-4 and, without `near_ties`, the same
    number of detections on every image. With `near_ties` (weights whose
    scores saturate at 1.0), a detection one device keeps and the other
    drops is allowed only where the decision about it
    (`flipped_detections`) lies within 1e-4 of its threshold; each is named
    with its image and gap."""
    import torch
    from yolou_tpu_torch.engine import validator
    from yolou_tpu_torch.models.yolo import build_yolo
    f32_exact(torch)
    got, metrics = {}, {}
    detect = validator.detect_batch

    def recorded(*args, **kw):
        out = detect(*args, **kw)
        got[next(args[0].parameters()).device.type].append(out)
        return out

    validator.detect_batch = recorded
    try:
        for dev in ("cuda", "cpu"):
            got[dev] = []
            model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                               device=dev)
            metrics[dev] = validator.validate_detector(
                model, weights, data, imgsz=EVAL_IMGSZ, batch_size=EVAL_BATCH)
    finally:
        validator.detect_batch = detect
    card, cpu = (np.concatenate(got[d])[:len(data)] for d in ("cuda", "cpu"))
    counts = card[..., 6].sum(1), cpu[..., 6].sum(1)
    flips = flipped_detections(card, cpu)
    worst = max(abs(metrics["cuda"][k] - metrics["cpu"][k])
                for k in metrics["cpu"])
    log("finetune", check=f"f32 validation card vs cpu, {what}",
        images=len(data), card=metrics["cuda"], cpu=metrics["cpu"],
        max_abs=worst, tol=1e-4, detections_card=int(counts[0].sum()),
        detections_cpu=int(counts[1].sum()),
        images_count_differs=np.nonzero(counts[0] != counts[1])[0].tolist(),
        flipped=[{"image": i, "kept_on": d, "decision": kind, "gap": g}
                 for i, d, kind, g in flips],
        near_tie_tol=1e-4 if near_ties else None)
    if near_ties:
        if any(abs(g) > 1e-4 for *_, g in flips):
            raise AssertionError(f"f32 validation card vs cpu, {what}: "
                                 f"detections differ beyond near-ties: "
                                 f"{flips}")
    elif not (np.array_equal(*counts) and counts[1].min() > 0):
        raise AssertionError(f"f32 validation card vs cpu, {what}: "
                             f"detections per image {counts}")
    if not worst <= 1e-4:
        raise AssertionError(f"f32 validation card vs cpu, {what}: "
                             f"{metrics}")


def finetune_phase(device):
    """The detector stage end to end on the card: the stem inflated,
    `DetectorTrainer.train()` at 160^2, batch 16, bf16 with validation every
    epoch (3 epochs, then resumed for a fourth), the best EMA weights
    validated in f32 on the card and the CPU, and written to a `.ckpt`
    model file and read back. Returns the launches of its paths."""
    import os
    import tempfile
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.data.yolo_dataset import collate_idmap_cached
    from yolou_tpu_torch.engine.predictor import Predictor
    from yolou_tpu_torch.engine.validator import validate_detector
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.utils.model_io import load_model, save_model
    rng = np.random.default_rng(SEED + 9)
    data = tuple(MemoryDetData(*make_labelled(rng, n, EVAL_IMGSZ))
                 for n in FT_SPLITS.values())
    sd = inflated_state_dict(data[0].imgs[:2])

    with tempfile.TemporaryDirectory() as run_dir:
        tr = ft_trainer(sd, None, torch.bfloat16, data,
                        os.path.join(run_dir, "a"), FT_EPOCHS)
        if tr.device.type != "cuda":
            raise AssertionError(f"the trainer chose {tr.device}")
        val_launches = watch_validations(tr)
        kernels.reset_launch_counts()
        history = tr.train()
        counts, backward = kernels.launch_counts(), kernels.backward_counts()
        train_paths = kernels.path_counts("band_attention_train")
        steps = FT_EPOCHS * FT_STEPS
        run = os.path.join(run_dir, "a", os.listdir(
            os.path.join(run_dir, "a"))[0])
        files = sorted(os.listdir(os.path.join(run, "weights")))
        log("finetune", check="train", steps=tr.step_count,
            epoch_seconds=tr.epoch_times, validation_seconds=tr.val_times,
            launches=counts, backward_calls=backward,
            band_attention_train_paths=train_paths, files=files, **history)
        log("finetune", validation_launches=val_launches,
            per_batch={k: v / FT_VAL_BATCHES
                       for k, v in val_launches[-1].items()})
        want = {"band_attention_train": 8 * steps,
                "band_attention": 8 * FT_VAL_BATCHES * FT_EPOCHS,
                "greedy_nms": FT_VAL_BATCHES * FT_EPOCHS, "a2c2f": 0}
        if (any(counts[k] != v for k, v in want.items())
                or backward["band_attention_train"] != 8 * steps
                or train_paths != {"short bf16": 8 * steps}):
            raise AssertionError(f"fine-tuning launched {counts}, backward "
                                 f"{backward}, kernel C's paths "
                                 f"{train_paths}, want {want}, each kernel "
                                 f"C launch short")
        if tr.step_count != steps or tr.notfinite_count():
            raise AssertionError(f"{tr.step_count} steps, "
                                 f"{tr.notfinite_count()} non-finite")
        if not (all(len(v) == FT_EPOCHS and np.isfinite(v).all()
                    for v in history.values())
                and all(0.0 <= v <= 1.0
                        for v in history["map50"] + history["map"])):
            raise AssertionError(f"history: {history}")
        if files != ["best.ckpt", "last.ckpt"]:
            raise AssertionError(f"the run wrote {files}")

        # the run's last.ckpt in a fresh trainer: the same state, bit for
        # bit, and the same next step from the same batch and generator
        last = os.path.join(run, "weights", "last.ckpt")
        fresh = ft_trainer(sd, None, torch.bfloat16, data,
                           os.path.join(run_dir, "c"), FT_EPOCHS)
        fresh.ensure_ready(FT_STEPS)
        state_io = reload_check("finetune", tr, fresh, last,
                                tr.save_checkpoint, fresh.load_resume)
        cb = collate_idmap_cached(data[0], list(range(EVAL_BATCH)), 16)
        batch = (cb["img"], cb["idmap"], cb["cls"], cb["valid"])

        def one_step(t):
            gen = torch.Generator(device=t.device).manual_seed(SEED + 1)
            return t.step(batch, gen, use_mosaic=False)[0]
        twin = twin_steps("finetune", tr, fresh, one_step)

        tr2 = ft_trainer(sd, None, torch.bfloat16, data,
                         os.path.join(run_dir, "b"), FT_EPOCHS + 1)
        kernels.reset_launch_counts()
        h2 = tr2.train(resume_from=last)
        resume_counts = kernels.launch_counts()
        log("finetune", check="resume", steps=tr2.step_count,
            epoch_seconds=tr2.epoch_times,
            validation_seconds=tr2.val_times, launches=resume_counts, **h2)
        if (tr2.step_count != steps + FT_STEPS
                or len(h2["loss"]) != 1 or len(h2["map50"]) != 1
                or resume_counts["greedy_nms"] != FT_VAL_BATCHES):
            raise AssertionError(f"resume ran {len(h2['loss'])} epochs to "
                                 f"step {tr2.step_count}")

        # times: a training step, a validation pass and its parts
        gen = torch.Generator(device=tr2.device).manual_seed(SEED)
        step_ms = cuda_ms(lambda: tr2.step(batch, gen, use_mosaic=True),
                          iters=5, warmup=1)
        val_model = tr2._val_model
        run_val = lambda: validate_detector(
            val_model, None, data[1], imgsz=EVAL_IMGSZ,
            batch_size=EVAL_BATCH)
        run_val()
        passes = 3
        t0 = time.perf_counter()
        for _ in range(passes):
            res = run_val()
        val_s = (time.perf_counter() - t0) / passes
        busy_ms, launches, top = profile_step(run_val, steps=1)
        parts = validation_breakdown(val_model, data[1])
        log("finetune", batch=EVAL_BATCH, imgsz=EVAL_IMGSZ, step_ms=step_ms,
            validation_s=val_s, validation_images_per_s=len(data[1]) / val_s,
            **parts, validation_busy_ms=busy_ms,
            validation_busy_share=busy_ms / (val_s * 1e3) if busy_ms else None,
            validation_device_launches=launches, top_device_kernels=top,
            metrics=res)
        log("finetune", epoch_s_without_validation=tr.epoch_times,
            epoch_s_with_validation=[a + b for a, b in zip(tr.epoch_times,
                                                            tr.val_times)])

        # the best EMA weights: f32 card vs CPU, then a model file
        keep = ft_trainer(sd, "cpu", torch.float32, data, run_dir, 1)
        keep.ensure_ready(FT_STEPS)
        keep.load_resume(os.path.join(run, "weights", "best.ckpt"))
        ema = keep.ema_variables()
        compare_validation_f32(sd, data[1], "calibrated", near_ties=False)
        compare_validation_f32(ema, data[1], "best EMA", near_ties=True)
        m32 = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                         device=device)
        m32.load_state_dict(ema, strict=True)
        path = os.path.join(run_dir, "best_ema.ckpt")
        save_model(path, m32)
        back = load_model(path)
        x = torch.from_numpy(data[1].imgs[:EVAL_BATCH]).to(device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad():
            a, b = m32(x), back(x)
        same = (torch.equal(a.preds, b.preds)
                and torch.equal(a.protos, b.protos)
                and all(torch.equal(p, q) for p, q in zip(a.raw, b.raw)))
        results = Predictor(back, imgsz=EVAL_IMGSZ, batch_size=EVAL_BATCH)(
            data[1].imgs[:EVAL_BATCH])
        dets = [len(r) for r in results]
        log("finetune", check="model file", bytes=os.path.getsize(path),
            device=str(next(back.parameters()).device),
            forward_bit_identical=same, request_detections=dets)
        if not same or next(back.parameters()).device.type != "cuda":
            raise AssertionError("the reloaded model's f32 forward differs")
        if len(results) != EVAL_BATCH or not all(
                np.isfinite(r.boxes.data).all() for r in results):
            raise AssertionError(f"the reloaded model answered {dets}")
    return {"validate": {k: sum(v[k] for v in val_launches)
                         for k in val_launches[0]},
            "train": counts["band_attention_train"],
            "train_paths": train_paths,
            "backward": backward["band_attention_train"],
            "training_state": dict(state_io, twin_step=twin)}


# ------------------------------------------------------------- command line

CLI_SPLITS = {"train": 256, "val": 64, "test": 64}
CLI_EPOCHS = 2
CLI_DEC_EPOCHS = 3
CLI_RETINA = 8          # val images predicted at 640^2 with --retina-masks
CLI_VERTICES = 32


@contextlib.contextmanager
def cv2_blocked():
    """`cv2` unimportable (a meta-path finder, and any loaded copy taken
    out of sys.modules) while the block runs, even where it is installed."""
    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] == "cv2":
                raise ImportError(f"blocked: {name}")

    saved = {k: sys.modules.pop(k) for k in list(sys.modules)
             if k.split(".")[0] == "cv2"}
    finder = Block()
    sys.meta_path.insert(0, finder)
    try:
        yield
    finally:
        sys.meta_path.remove(finder)
        sys.modules.update(saved)


def write_split(root: str, split: str, count: int, rng, hw: int = EVAL_IMGSZ):
    """`count` images of bright ellipses on dark noise, drawn as
    `make_labelled` draws them, in `data/synthetic.py`'s layout: 4-channel
    PNGs under images/, gray masks (255 inside an ellipse) under masks/,
    and under labels/ a YOLO polygon of CLI_VERTICES vertices on each
    ellipse. Returns the arrays written (images, masks)."""
    import os
    from yolou_tpu_torch.native.image import imwrite
    dirs = {k: os.path.join(root, k, split)
            for k in ("images", "masks", "labels")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    yy, xx = np.mgrid[:hw, :hw]
    t = 2 * np.pi * np.arange(CLI_VERTICES) / CLI_VERTICES
    imgs, masks = [], []
    for i in range(count):
        img = rng.normal(40, 12, (hw, hw, 4)).clip(0, 255)
        mask = np.zeros((hw, hw), np.uint8)
        rows = []
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0.2 * hw, 0.8 * hw, 2)
            ry, rx = rng.uniform(0.04 * hw, 0.15 * hw, 2)
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            img[inside] = rng.uniform(180, 255, 4)
            mask[inside] = 255
            poly = np.stack([(cx + rx * np.cos(t)) / hw,
                             (cy + ry * np.sin(t)) / hw], 1).clip(0, 1)
            rows.append("0 " + " ".join(f"{c:.6f}" for c in poly.ravel()))
        name = f"{split}_{i:04d}"
        img = img.astype(np.uint8)
        imwrite(os.path.join(dirs["images"], name + ".png"), img)
        imwrite(os.path.join(dirs["masks"], name + ".png"), mask)
        with open(os.path.join(dirs["labels"], name + ".txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
        imgs.append(img)
        masks.append(mask)
    return np.stack(imgs), np.stack(masks)


def write_dataset(root: str, rng) -> dict:
    """Every split of CLI_SPLITS and data.yaml; returns the arrays."""
    import os
    arrays = {s: write_split(root, s, n, rng) for s, n in CLI_SPLITS.items()}
    with open(os.path.join(root, "data.yaml"), "w") as f:
        f.write(f"path: {root}\ntrain: images/train\nval: images/val\n"
                f"test: images/test\nchannels: 4\nnc: 1\n"
                f'names: ["whole_tumor"]\n')
    return arrays


def check_codec(root: str, arrays: dict) -> dict:
    """Every image and mask read back with the port's `imread` equals the
    array written, byte for byte; one seeded image makes the round trip
    through each of the five PNG filter types. Returns decode and resize
    rates (host, images/s)."""
    import os
    import tempfile
    from yolou_tpu_torch.native import image
    n, t_read = 0, 0.0
    for split, (imgs, masks) in arrays.items():
        for i in range(len(imgs)):
            name = f"{split}_{i:04d}.png"
            t0 = time.perf_counter()
            img = image.imread(os.path.join(root, "images", split, name))
            t_read += time.perf_counter() - t0
            mask = image.imread(os.path.join(root, "masks", split, name),
                                image.IMREAD_GRAYSCALE)
            if not (np.array_equal(img, imgs[i])
                    and np.array_equal(mask, masks[i])):
                raise AssertionError(f"{split}/{name} read back differs")
            n += 1
    probe = np.random.default_rng(SEED + 11).integers(
        0, 256, (EVAL_IMGSZ, EVAL_IMGSZ, 4), dtype=np.uint8)
    with tempfile.TemporaryDirectory() as d:
        for ftype in range(5):
            path = os.path.join(d, f"f{ftype}.png")
            image.imwrite(path, probe, filter_type=ftype)
            if not np.array_equal(image.imread(path), probe):
                raise AssertionError(f"filter type {ftype}: round trip")
    val = arrays["val"][0]
    t0 = time.perf_counter()
    for img in val:
        image.resize_linear(img, (IMGSZ, IMGSZ))
    t_resize = time.perf_counter() - t0
    return {"images_checked": n, "filter_types": 5,
            "decode_images_per_s": n / t_read,
            "resize_160_to_640_images_per_s": len(val) / t_resize}


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def run_command(argv, counts: dict, seconds: dict, key=None):
    """`__main__.main(argv)` in this process with the kernels' launch
    counters set to 0 just before and read just after; its launches and
    wall seconds go under `key` (the command's name). Returns (what the
    command returned, its printed output)."""
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.__main__ import main
    key = key or argv[0]
    tee = Tee(sys.stdout)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        out = main(argv)
    torch.cuda.synchronize()
    seconds[key] = time.perf_counter() - t0
    counts[key] = dict(kernels.launch_counts(),
                       backward=kernels.backward_counts())
    return out, "".join(tee.parts)


def cli_val_f32(yaml: str, ckpt: str, counts, seconds) -> None:
    """`val` in f32 on the card and with `--device cpu` on the same file:
    metrics within 1e-4; detections equal on every image but for near-ties
    (`flipped_detections`, each named, within 1e-4 of its decision)."""
    import torch
    from yolou_tpu_torch.engine import validator
    f32_exact(torch)
    got, metrics = {"cuda": [], "cpu": []}, {}
    detect = validator.detect_batch

    def recorded(*args, **kw):
        out = detect(*args, **kw)
        got[next(args[0].parameters()).device.type].append(out)
        return out

    validator.detect_batch = recorded
    try:
        for dev in ("cuda", "cpu"):
            metrics[dev], _ = run_command(
                ["val", "--data", yaml, "--model", ckpt, "--imgsz",
                 str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--device",
                 dev], counts, seconds, key=f"val f32 {dev}")
    finally:
        validator.detect_batch = detect
    n = CLI_SPLITS["val"]
    card, cpu = (np.concatenate(got[d])[:n] for d in ("cuda", "cpu"))
    dets = card[..., 6].sum(1), cpu[..., 6].sum(1)
    flips = flipped_detections(card, cpu)
    worst = max(abs(metrics["cuda"][k] - metrics["cpu"][k])
                for k in metrics["cpu"])
    log("cli", check="val f32 card vs cpu", images=n, card=metrics["cuda"],
        cpu=metrics["cpu"], max_abs=worst, tol=1e-4,
        detections_card=int(dets[0].sum()), detections_cpu=int(dets[1].sum()),
        images_count_differs=np.nonzero(dets[0] != dets[1])[0].tolist(),
        flipped=[{"image": i, "kept_on": d, "decision": kind, "gap": g}
                 for i, d, kind, g in flips])
    if any(abs(g) > 1e-4 for *_, g in flips) or not worst <= 1e-4:
        raise AssertionError(f"val f32 card vs cpu: {metrics}, {flips}")


def cli_phase(device, root: str):
    """The Quickstart through `python -m yolou_tpu_torch`'s dispatcher on
    the card at the reference configuration, from PNG files written under
    `root`, with cv2 blocked. Leaves its files there (init.ckpt, det.ckpt,
    runs/segpp_final.ckpt, the splits' PNGs) for the phases after it.
    Returns the launches of each command."""
    import os
    import torch
    from yolou_tpu_torch.__main__ import COMMANDS
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.native import loader
    from yolou_tpu_torch.utils.model_io import load_model, save_model
    t0 = time.perf_counter()
    lib = loader.build()
    log("cli", native_library=lib.name,
        build_seconds=time.perf_counter() - t0)
    counts, seconds = {}, {}
    rng = np.random.default_rng(SEED + 21)
    with cv2_blocked():
        t0 = time.perf_counter()
        arrays = write_dataset(root, rng)
        log("cli", dataset=CLI_SPLITS, write_seconds=time.perf_counter() - t0)
        log("cli", **check_codec(root, arrays))
        yaml = os.path.join(root, "data.yaml")

        res = subprocess.run([sys.executable, "-m", "yolou_tpu_torch",
                              "--help"], capture_output=True, text=True,
                             timeout=300)
        listed = res.stdout.split("commands:")[-1].split()
        log("cli", check="--help", rc=res.returncode, commands=listed)
        if res.returncode != 0 or listed != list(COMMANDS):
            raise AssertionError(f"--help: {res.returncode} {res.stdout}")

        # the starting weights: seeded, stem inflated, calibrated at 160^2
        init = os.path.join(root, "init.ckpt")
        m = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
        m.load_state_dict(inflated_state_dict(arrays["train"][0][:2]))
        save_model(init, m)

        det = os.path.join(root, "det.ckpt")
        hist, out = run_command(
            ["train-detector", "--data", yaml, "--model", init, "--imgsz",
             str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--epochs",
             str(CLI_EPOCHS), "--val-every", "1", "--run-dir",
             os.path.join(root, "runs_det"), "--out", det, "--dtype",
             "bfloat16"], counts, seconds)
        epoch_s = [float(ln.split("[")[-1].split("s,")[0])
                   for ln in out.splitlines() if ln.startswith("epoch ")]
        if not (len(hist["loss"]) == CLI_EPOCHS
                and np.isfinite(hist["loss"]).all()
                and all(0 <= v <= 1 for v in hist["map50"])):
            raise AssertionError(f"train-detector: {hist}")

        maps, _ = run_command(
            ["generate-objectmaps", "--data_dir", root, "--yolo_dir", det,
             "--image_size", str(EVAL_IMGSZ), "--batch_size",
             str(DEC_BATCH), "--bf16"], counts, seconds)
        if maps != CLI_SPLITS:
            raise AssertionError(f"generate-objectmaps: {maps}")
        dec, out = run_command(
            ["train-decoder", "--model", det, "--data", root, "--imgsz",
             str(EVAL_IMGSZ), "--batch", str(DEC_BATCH), "--epochs",
             str(CLI_DEC_EPOCHS), "--bf16", "--run-dir",
             os.path.join(root, "runs")], counts, seconds)
        dec_epoch_s = [float(ln.split("[")[-1].split("s train")[0])
                       for ln in out.splitlines() if ln.startswith("epoch ")]
        final = os.path.join(root, "runs", "segpp_final.ckpt")
        if len(dec["train_loss"]) != CLI_DEC_EPOCHS or not os.path.exists(
                final):
            raise AssertionError(f"train-decoder: {dec}")
        ev, _ = run_command(
            ["evaluate", "--model", final, "--data", root, "--imgsz",
             str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--bf16"],
            counts, seconds)
        if ev["n_images"] != CLI_SPLITS["test"] or not all(
                0 <= ev[k] <= 1 for k in ("dice", "precision", "recall")):
            raise AssertionError(f"evaluate: {ev}")

        val_dir = os.path.join(root, "images", "val")
        results, _ = run_command(
            ["predict", "--source", val_dir, "--model", det, "--imgsz",
             str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--bf16"],
            counts, seconds)
        lst = os.path.join(root, "retina.txt")
        with open(lst, "w") as f:
            f.write("\n".join(os.path.join(val_dir, f"val_{i:04d}.png")
                              for i in range(CLI_RETINA)) + "\n")
        retina, _ = run_command(
            ["predict", "--source", lst, "--model", det, "--imgsz",
             str(IMGSZ), "--batch", str(CLI_RETINA), "--retina-masks",
             "--bf16"], counts, seconds, key="predict retina 640")
        shapes = {r.masks.data.shape[1:] for r in retina if len(r)}
        if (len(results) != CLI_SPLITS["val"] or len(retina) != CLI_RETINA
                or shapes - {(EVAL_IMGSZ, EVAL_IMGSZ)}):
            raise AssertionError(f"predict: {len(results)} results, retina "
                                 f"mask shapes {shapes}")
        val, _ = run_command(
            ["val", "--data", yaml, "--model", det, "--imgsz",
             str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--rect",
             "--bf16"], counts, seconds, key="val --rect")

        pt, det2 = os.path.join(root, "det.pt"), os.path.join(root,
                                                             "det2.ckpt")
        run_command(["convert", "--reverse", "--out", det, "--pt", pt],
                    counts, seconds, key="convert --reverse")
        strict = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                            device=device)
        strict.load_state_dict(torch.load(pt, weights_only=True),
                               strict=True)
        run_command(["convert", "--pt", pt, "--out", det2], counts, seconds)
        a, b = load_model(det), load_model(det2)
        x = torch.from_numpy(arrays["val"][0][:EVAL_BATCH]).to(device)
        x = x.permute(0, 3, 1, 2).float() / 255.0
        with torch.no_grad():
            oa, ob = a(x), b(x)
        same = (torch.equal(oa.preds, ob.preds)
                and torch.equal(oa.protos, ob.protos)
                and all(torch.equal(p, q) for p, q in zip(oa.raw, ob.raw)))
        log("cli", check="convert round trip", forward_bit_identical=same)
        if not same:
            raise AssertionError("convert: the round-tripped file differs")

        # the module entry, in a process of its own, cv2 blocked there too
        block = ("import runpy, sys\n"
                 "class B:\n"
                 "    def find_spec(self, n, p=None, t=None):\n"
                 "        if n.split('.')[0] == 'cv2': raise ImportError(n)\n"
                 "sys.meta_path.insert(0, B())\n"
                 "sys.argv = ['yolou_tpu_torch'] + sys.argv[1:]\n"
                 "runpy.run_module('yolou_tpu_torch', run_name='__main__')\n")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", block, "val", "--data", yaml, "--model",
             det, "--imgsz", str(EVAL_IMGSZ), "--bf16"],
            capture_output=True, text=True, timeout=600)
        seconds["python -m val"] = time.perf_counter() - t0
        sub = json.loads(res.stdout) if res.returncode == 0 else None
        log("cli", check="python -m yolou_tpu_torch val", rc=res.returncode,
            metrics=sub, stderr_tail=res.stderr[-2000:])
        if sub is None or set(sub) != set(val):
            raise AssertionError(f"python -m yolou_tpu_torch val: rc "
                                 f"{res.returncode}")

        # exact launches: C 8 + 8 a step, A 8 and B 1 a batch where they run
        steps = CLI_EPOCHS * -(-CLI_SPLITS["train"] // EVAL_BATCH)
        val_batches = CLI_SPLITS["val"] // EVAL_BATCH
        om_batches = sum(-(-n // DEC_BATCH) for n in CLI_SPLITS.values())
        test_batches = CLI_SPLITS["test"] // EVAL_BATCH
        want = {
            "train-detector": (8 * steps, 8 * steps,
                               8 * val_batches * CLI_EPOCHS,
                               val_batches * CLI_EPOCHS),
            "generate-objectmaps": (0, 0, 8 * om_batches, 0),
            "train-decoder": (0, 0, 0, 0),
            "evaluate": (0, 0, 8 * test_batches, test_batches),
            "predict": (0, 0, 8 * val_batches, val_batches),
            "predict retina 640": (0, 0, 8, 1),
            "val --rect": (0, 0, 8 * val_batches, val_batches),
            "convert --reverse": (0, 0, 0, 0), "convert": (0, 0, 0, 0)}
        for key, (c, cb, a_, b_) in want.items():
            n = counts[key]
            have = (n["band_attention_train"],
                    n["backward"]["band_attention_train"],
                    n["band_attention"], n["greedy_nms"])
            log("cli", command=key, seconds=seconds[key], launches=n)
            if have != (c, cb, a_, b_) or n["a2c2f"] != 0:
                raise AssertionError(f"{key}: launches (C, C backward, A, B)"
                                     f" {have} and a2c2f {n['a2c2f']}, want "
                                     f"{(c, cb, a_, b_)} and 0")

        cli_val_f32(yaml, det, counts, seconds)
        evs = {dev: run_command(
            ["evaluate", "--model", final, "--data", root, "--imgsz",
             str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--device", dev],
            counts, seconds, key=f"evaluate f32 {dev}")[0]
            for dev in ("cuda", "cpu")}
        worst = max(abs(evs["cuda"][k] - evs["cpu"][k])
                    for k in ("dice", "precision", "recall"))
        log("cli", check="evaluate f32 card vs cpu", card=evs["cuda"],
            cpu=evs["cpu"], max_abs=worst, tol=1e-4)
        if not worst <= 1e-4:
            raise AssertionError(f"evaluate f32 card vs cpu: {evs}")

    log("cli", command_seconds=seconds)
    log("cli", predict_images_per_s=CLI_SPLITS["val"] / seconds["predict"],
        predict_retina_640_images_per_s=CLI_RETINA
        / seconds["predict retina 640"],
        detector_epoch_s=epoch_s, decoder_epoch_train_s=dec_epoch_s)
    return {"train": counts["train-detector"]["band_attention_train"],
            "backward": counts["train-detector"]["backward"][
                "band_attention_train"],
            **{k: {"band_attention": counts[k]["band_attention"],
                   "greedy_nms": counts[k]["greedy_nms"]}
               for k in ("train-detector", "generate-objectmaps",
                         "evaluate", "predict", "predict retina 640",
                         "val --rect")}}


# ------------------------------------- export, profile, visualize-logits

EXPORT_CALLS = 20      # timed calls of the exported program and of infer
EXPORT_OPS = {"band_attention_qkv": 8, "greedy_nms": 1}
SEG_TIE = 1e-2         # |sigmoid - 0.5| under which mask pixels may differ


def graph_kernel_ops(program) -> dict:
    """The kernel operators (`yolou::*`) of an ExportedProgram's graph and
    how often each is called."""
    ops = {}
    for node in program.graph.nodes:
        name = str(node.target)
        if node.op == "call_function" and name.startswith("yolou."):
            key = name.split(".")[1]
            ops[key] = ops.get(key, 0) + 1
    return ops


def counted(fn):
    """(fn(), the kernels' launches during it), counters set to 0 just
    before the call and read just after it."""
    import torch
    from yolou_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def forward_launches(counts: dict) -> dict:
    """`run_command`'s counts of a command without its backward calls."""
    return {k: v for k, v in counts.items() if k != "backward"}


def check_launches(what: str, counts: dict, a: int, b: int, **more) -> None:
    """Exactly `a` launches of kernel A and `b` of kernel B, the counts
    `more` names of the others (and of anything else `counts` holds, such
    as backward calls), none other."""
    want = {"band_attention": a, "greedy_nms": b, "band_attention_train": 0,
            "band_attention_single": 0, "a2c2f": 0, **more}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")


def detection_rows(boxes, conf, cls, valid) -> np.ndarray:
    """(B, max_det, 7) [box, conf, cls, valid] rows, as the validator's."""
    import torch
    return torch.cat([boxes, conf[..., None], cls[..., None],
                      valid[..., None].to(boxes.dtype)], -1).cpu().numpy()


def export_phase(device, root: str) -> dict:
    """`export` of the cli phase's seeded, calibrated init.ckpt at 640^2,
    batch 8, in bf16 and in f32 (no launch while tracing; 8 kernel A and 1
    kernel B operator nodes in the graph), each run as an ExportedModel on
    8 seeded images (exactly 8 A + 1 B launches a call) beside the live
    `Predictor.infer`: f32 boxes within 1e-3, scores within 1e-5, `valid`
    equal; bf16 the same detection counts but for near-ties
    (`flipped_detections`); the bf16 call timed against infer. Then
    `--kind segpp` of runs/segpp_final.ckpt at 160^2, batch 16, bf16: the
    mask against the live YOLOSegPP's sigmoid thresholded at 0.5 on 16 test
    PNGs. Returns the launches of one call of each program."""
    import os
    import torch
    from yolou_tpu_torch.engine.exporter import ExportedModel
    from yolou_tpu_torch.engine.predictor import Predictor
    from yolou_tpu_torch.native.image import imread
    from yolou_tpu_torch.utils.model_io import load_model
    f32_exact(torch)
    counts, seconds, launches = {}, {}, {}
    init = os.path.join(root, "init.ckpt")
    imgs = torch.from_numpy(make_images(np.random.default_rng(SEED + 31),
                                        BATCH, IMGSZ)).to(device)
    programs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        key = f"export {name}"
        out_dir = os.path.join(root, f"export_{name}")
        meta, _ = run_command(
            ["export", "--model", init, "--out", out_dir, "--imgsz",
             str(IMGSZ), "--batch", str(BATCH)]
            + (["--bf16"] if name == "bf16" else []), counts, seconds, key)
        t0 = time.perf_counter()
        ex = ExportedModel(out_dir)
        load_s = time.perf_counter() - t0
        ops = graph_kernel_ops(ex.program)
        sizes = {f: os.path.getsize(os.path.join(out_dir, f))
                 for f in sorted(os.listdir(out_dir))}
        log("export", check=key, seconds=seconds[key], load_seconds=load_s,
            graph_ops=ops, files=sizes, platforms=meta["platforms"],
            launches_while_tracing=counts[key])
        if any(forward_launches(counts[key]).values()):
            raise AssertionError(f"{key}: kernels launched while tracing")
        if ops != EXPORT_OPS or meta["platforms"] != [device.type]:
            raise AssertionError(f"{key}: graph operators {ops}, platforms "
                                 f"{meta['platforms']}")
        live = Predictor(load_model(init, dtype=dtype, device=device),
                         imgsz=IMGSZ, batch_size=BATCH)
        got, n = counted(lambda: ex(imgs))
        check_launches(f"{key} call", n, 8, 1)
        launches[name] = n
        with torch.no_grad():
            dets, out = live.infer(imgs)
        want = (dets.boxes, dets.conf, dets.cls, dets.valid, dets.extra,
                out.protos.permute(0, 2, 3, 1))
        errs = {k: (g.float() - w.float()).abs().max().item()
                for k, g, w in zip(("boxes", "conf", "cls", "valid",
                                    "mask_coefs", "protos"), got, want)}
        counts_got = got[3].sum(1).tolist()
        counts_want = want[3].sum(1).tolist()
        flips = flipped_detections(detection_rows(*got[:4]),
                                   detection_rows(*want[:4]),
                                   conf_thres=0.25)
        log("export", check=f"{key} vs live Predictor.infer", images=BATCH,
            max_abs=errs, detections_exported=counts_got,
            detections_live=counts_want,
            flipped=[{"image": i, "kept_on": "exported" if d == "card"
                      else "live", "decision": kind, "gap": g}
                     for i, d, kind, g in flips])
        if sum(counts_want) < 1:
            raise AssertionError(f"{key}: no detection to compare")
        if name == "f32" and not (errs["boxes"] <= 1e-3 and errs["conf"] <= 1e-5
                                  and torch.equal(got[3], want[3])):
            raise AssertionError(f"{key}: exported vs live {errs}")
        if name == "bf16" and any(abs(g) > 1e-4 for *_, g in flips):
            raise AssertionError(f"{key}: detections differ {flips}")
        programs[name] = (ex, live)

    ex, live = programs["bf16"]
    times = {"live": [], "exported": []}
    with torch.no_grad():
        for which in ("live", "exported", "exported", "live"):
            fn = ((lambda: live.infer(imgs)) if which == "live"
                  else (lambda: ex(imgs)))
            times[which].append(kernel_times(fn, EXPORT_CALLS))
    log("export", check=f"bf16 call, batch {BATCH}, {IMGSZ}^2",
        calls=EXPORT_CALLS,
        exported_event_ms=[t[1] for t in times["exported"]],
        live_infer_event_ms=[t[1] for t in times["live"]],
        exported_device_ms=[t[0] for t in times["exported"]],
        live_infer_device_ms=[t[0] for t in times["live"]],
        ratio_event=float(np.mean([t[1] for t in times["exported"]])
                          / np.mean([t[1] for t in times["live"]])))

    final = os.path.join(root, "runs", "segpp_final.ckpt")
    seg_dir = os.path.join(root, "export_segpp")
    meta, _ = run_command(
        ["export", "--kind", "segpp", "--model", final, "--out", seg_dir,
         "--imgsz", str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--bf16"],
        counts, seconds, key="export segpp")
    ex = ExportedModel(seg_dir)
    ops = graph_kernel_ops(ex.program)
    test_dir = os.path.join(root, "images", "test")
    x = torch.from_numpy(np.stack([
        imread(os.path.join(test_dir, f))
        for f in sorted(os.listdir(test_dir))[:EVAL_BATCH]])).to(device)
    (mask, _, _, valid), n = counted(lambda: ex(x))
    check_launches("export segpp call", n, 8, 1)
    launches["segpp"] = n
    model = load_model(final, dtype=torch.bfloat16, device=device)
    with torch.no_grad():
        logits, _ = model(x.permute(0, 3, 1, 2).float() / 255.0)
    prob = torch.sigmoid(logits).permute(0, 2, 3, 1)
    differ = mask != (prob > 0.5).to(torch.uint8)
    worst = ((prob[differ] - 0.5).abs().max().item() if differ.any()
             else 0.0)
    log("export", check="segpp mask vs live YOLOSegPP, bf16",
        seconds=seconds["export segpp"], graph_ops=ops,
        mask_shape=list(mask.shape), pixels=differ.numel(),
        equal_share=1.0 - differ.float().mean().item(),
        differing=int(differ.sum()), worst_differing_margin=worst,
        tol=SEG_TIE, foreground_share=mask.float().mean().item(),
        detections=valid.sum(1).tolist())
    if (ops != EXPORT_OPS or tuple(mask.shape) != (EVAL_BATCH, EVAL_IMGSZ,
                                                   EVAL_IMGSZ, 1)
            or worst >= SEG_TIE):
        raise AssertionError(f"export segpp: operators {ops}, mask "
                             f"{tuple(mask.shape)}, a pixel {worst} from "
                             f"0.5 differs")
    return launches


def profile_phase(device, root: str) -> dict:
    """`profile --batch 8 --imgsz 640` (bf16, every prefix, device ms):
    no negative row, `total_ms` within 15 % of the device ms of one whole
    forward of the same model and input; the five costliest rows and the
    ranks of layers 6 and 8 (kernel A's). Then `profile --attn --batch 8`.
    Returns the per-layer run's launches."""
    import os
    import torch
    from yolou_tpu_torch.tools.profile_layers import (device_ms,
                                                      profiled_model)
    counts, seconds = {}, {}
    out = os.path.join(root, "PROFILE.json")
    prof, _ = run_command(["profile", "--batch", str(BATCH), "--imgsz",
                           str(IMGSZ), "--out", out], counts, seconds)
    rows = prof["per_layer"]
    model, x = profiled_model(BATCH, IMGSZ, "bfloat16", device)
    with torch.no_grad():
        whole = device_ms(lambda: model(x), iters=20)
    ranked = sorted(rows, key=lambda r: -r["ms"])
    rank = {r["layers"]: i + 1 for i, r in enumerate(ranked)}
    ratio = prof["total_ms"] / whole
    n = counts["profile"]
    log("profile", seconds=seconds["profile"], card=prof["card"],
        timer=prof["timer"], rows=len(rows), total_ms=prof["total_ms"],
        total_half_spread_ms=prof["total_half_spread_ms"],
        whole_forward_device_ms=whole, ratio=ratio, tol=0.15,
        costliest=[{k: r[k] for k in ("layers", "block", "ms")}
                   for r in ranked[:5]],
        layer6_rank=rank.get("6..6"), layer8_rank=rank.get("8..8"),
        layer6_ms=[r["ms"] for r in rows if r["layers"] == "6..6"],
        layer8_ms=[r["ms"] for r in rows if r["layers"] == "8..8"],
        launches=n)
    if any(r["ms"] < 0 for r in rows) or not 0.85 <= ratio <= 1.15:
        raise AssertionError(f"profile: total {prof['total_ms']} ms vs "
                             f"{whole} ms, rows {rows}")
    if not n["band_attention"] or n["greedy_nms"] or n["a2c2f"]:
        raise AssertionError(f"profile: launches {n}")
    attn, _ = run_command(["profile", "--attn", "--batch", str(BATCH),
                           "--out", os.path.join(root, "PROFILE_attn.json")],
                          counts, seconds, key="profile --attn")
    na = counts["profile --attn"]
    log("profile", check="--attn", launches=na,
        **{k: v["ms"] for k, v in attn.items()})
    if min(na["band_attention_single"], na["band_attention_train"]) < 1:
        raise AssertionError(f"profile --attn: launches {na}")
    return n


def visualize_phase(device, root: str) -> dict:
    """`visualize-logits` on one PNG of the cli phase with its trained
    det.ckpt, f32, on the card and with `--device cpu`: probabilities
    within 1e-5, the printed statistics equal; kernel A 8 launches on the
    card, none on the CPU. Returns the card run's launches."""
    import os
    counts, seconds, probs, stats = {}, {}, {}, {}
    png = os.path.join(root, "images", "val", "val_0000.png")
    for dev in ("cuda", "cpu"):
        key = f"visualize-logits {dev}"
        probs[dev], out = run_command(
            ["visualize-logits", png, "--yolo_dir",
             os.path.join(root, "det.ckpt"), "--image_size",
             str(EVAL_IMGSZ), "--out", os.path.join(root, f"logits_{dev}.png"),
             "--device", dev], counts, seconds, key)
        stats[dev] = [ln for ln in out.splitlines()
                      if ln.startswith(("spatial_", "argmax_"))]
    err = float(np.abs(probs["cuda"] - probs["cpu"]).max())
    log("visualize-logits", shape=list(probs["cuda"].shape), max_abs=err,
        tol=1e-5, card=stats["cuda"], cpu=stats["cpu"],
        seconds={d: seconds[f"visualize-logits {d}"] for d in probs},
        launches_card=counts["visualize-logits cuda"],
        launches_cpu=counts["visualize-logits cpu"])
    for dev, a in (("cuda", 8), ("cpu", 0)):
        check_launches(f"visualize-logits {dev}",
                       forward_launches(counts[f"visualize-logits {dev}"]),
                       a, 0)
    if not (err <= 1e-5 and len(stats["cuda"]) == 2
            and stats["cuda"] == stats["cpu"]
            and probs["cuda"].shape == (EVAL_IMGSZ // 8, EVAL_IMGSZ // 8)):
        raise AssertionError(f"visualize-logits card vs cpu: {err}, {stats}")
    return counts["visualize-logits cuda"]


# ------------------------------------------------ the yolov8 / yolo11 graphs

FAMILIES = ("yolov8", "yolo11")
PSA_LAYER = 10          # yolo11's C2PSA stage


def family_forwards(device, weights: dict, imgs) -> dict:
    """The batch-8 bf16 forward at 640^2 of each graph of `weights` (yolov12
    beside the two families), timed in turns (CUDA events, then a profiler
    window: device ms and device launches a forward); and yolo11's PSA
    stage (layer 10) alone on its input, device ms."""
    import torch
    from yolou_tpu_torch.ops.letterbox import letterbox_batch
    from yolou_tpu_torch.tools.profile_layers import device_ms
    x = letterbox_batch(torch.from_numpy(imgs).to(device), (IMGSZ, IMGSZ))
    x = x.permute(0, 3, 1, 2).contiguous()
    models = {a: build_model(sd, device, torch.bfloat16, arch=a)
              for a, sd in weights.items()}
    order = list(models) + list(models)[::-1]
    event_ms = {a: [] for a in models}
    with torch.no_grad():
        for a in order:
            event_ms[a].append(cuda_ms(lambda: models[a](x), iters=10))
        prof = {a: profile_step(lambda: models[a](x)) for a in models}
        m = models["yolo11"]
        y = m(x, taps=(PSA_LAYER - 1,), stop_at=PSA_LAYER).taps[PSA_LAYER - 1]
        psa = m.model[PSA_LAYER]
        psa_ms = device_ms(lambda: psa(y), iters=20)
    out = {}
    for a in models:
        out[a] = {"event_ms": event_ms[a], "device_ms": prof[a][0],
                  "launches": prof[a][1], "top": prof[a][2]}
        log("families", check=f"forward, batch {BATCH}, {IMGSZ}^2, bf16",
            arch=a, **out[a])
    log("families", check="yolo11 PSA stage (layer 10) alone",
        input_shape=list(y.shape), device_ms=psa_ms)
    out["yolo11 psa"] = psa_ms
    return out


def family_commands(device, root: str, arch: str, state_dict,
                    counts: dict, seconds: dict) -> None:
    """In the cli phase's directory, cv2 blocked: a port-written `.pt` of
    the seeded weights through `convert --arch`, then `predict`, `val` (the
    160^2 PNG split), `export` (640^2, batch 8, f32: one kernel B launch
    and no attention a call; boxes, scores and `valid` against the live
    `Predictor.infer`) and `train-detector --epochs 1` from that `.ckpt`.
    Every file written names `arch`; the fine-tuned one loads back."""
    import os
    import torch
    from yolou_tpu_torch.engine.exporter import ExportedModel
    from yolou_tpu_torch.engine.predictor import Predictor
    from yolou_tpu_torch.utils.checkpoint import load_checkpoint
    from yolou_tpu_torch.utils.model_io import load_model

    def arch_of(path):
        return json.loads(load_checkpoint(path)["meta_json"])["arch"]

    yaml = os.path.join(root, "data.yaml")
    pt = os.path.join(root, f"{arch}.pt")
    ckpt = os.path.join(root, f"{arch}.ckpt")
    torch.save(state_dict, pt)
    key = f"{arch} convert"
    rep, _ = run_command(["convert", "--pt", pt, "--arch", arch, "--out",
                          ckpt], counts, seconds, key)
    if rep["missing"] or rep["unused"] or arch_of(ckpt) != arch:
        raise AssertionError(f"{key}: {rep}, arch {arch_of(ckpt)}")
    check_launches(key, forward_launches(counts[key]), 0, 0)

    val_batches = CLI_SPLITS["val"] // EVAL_BATCH
    key = f"{arch} predict"
    results, _ = run_command(
        ["predict", "--source", os.path.join(root, "images", "val"),
         "--model", ckpt, "--imgsz", str(EVAL_IMGSZ), "--batch",
         str(EVAL_BATCH), "--bf16"], counts, seconds, key)
    if len(results) != CLI_SPLITS["val"]:
        raise AssertionError(f"{key}: {len(results)} results")
    check_launches(key, forward_launches(counts[key]), 0, val_batches)
    key = f"{arch} val"
    val, _ = run_command(
        ["val", "--data", yaml, "--model", ckpt, "--imgsz", str(EVAL_IMGSZ),
         "--batch", str(EVAL_BATCH), "--bf16"], counts, seconds, key)
    if not all(0 <= v <= 1 for v in val.values()):
        raise AssertionError(f"{key}: {val}")
    check_launches(key, forward_launches(counts[key]), 0, val_batches)

    key = f"{arch} export"
    out_dir = os.path.join(root, f"export_{arch}")
    meta, _ = run_command(
        ["export", "--model", ckpt, "--out", out_dir, "--imgsz", str(IMGSZ),
         "--batch", str(BATCH)], counts, seconds, key)
    check_launches(key, forward_launches(counts[key]), 0, 0)
    ex = ExportedModel(out_dir)
    ops = graph_kernel_ops(ex.program)
    imgs = torch.from_numpy(make_images(np.random.default_rng(SEED + 43),
                                        BATCH, IMGSZ)).to(device)
    got, n = counted(lambda: ex(imgs))
    check_launches(f"{key} call", forward_launches(n), 0, 1)
    counts[f"{key} call"] = n
    live = Predictor(load_model(ckpt, device=device), imgsz=IMGSZ,
                     batch_size=BATCH)
    with torch.no_grad():
        dets, _ = live.infer(imgs)
    errs = {k: (g.float() - w.float()).abs().max().item() for k, g, w in
            zip(("boxes", "conf"), got, (dets.boxes, dets.conf))}
    log("families", arch=arch, check="export f32 vs live Predictor.infer",
        graph_ops=ops, meta_arch=meta["arch"], max_abs=errs,
        detections=got[3].sum(1).tolist())
    if not (ops == {"greedy_nms": 1} and meta["arch"] == arch
            and errs["boxes"] <= 1e-3 and errs["conf"] <= 1e-5
            and torch.equal(got[3], dets.valid)
            and int(dets.valid.sum()) > 0):
        raise AssertionError(f"{key}: operators {ops}, arch {meta['arch']}, "
                             f"{errs}")

    key = f"{arch} train-detector"
    ft = os.path.join(root, f"{arch}_ft.ckpt")
    hist, _ = run_command(
        ["train-detector", "--data", yaml, "--model", ckpt, "--imgsz",
         str(EVAL_IMGSZ), "--batch", str(EVAL_BATCH), "--epochs", "1",
         "--run-dir", os.path.join(root, f"runs_{arch}"), "--out", ft,
         "--dtype", "bfloat16"], counts, seconds, key)
    check_launches(key, forward_launches(counts[key]), 0, 0)
    back = load_model(ft, device=device)
    if (arch_of(ft) != arch or back.spec.arch != arch
            or not np.isfinite(hist["loss"]).all()):
        raise AssertionError(f"{key}: arch {arch_of(ft)}, history {hist}")
    for k in (f"{arch} {c}" for c in ("convert", "predict", "val", "export",
                                      "train-detector")):
        log("families", command=k, seconds=seconds[k], launches=counts[k])


def families_phase(device, root: str, yolov12_state_dict) -> dict:
    """The yolov8 and yolo11 graphs (n scale, 4 channels, nc=1, segment,
    seeded and calibrated weights, the head bias warm-started): for each, a
    Predictor answering 3 requests of 8 images at 640^2 in bf16 (a
    detection on every image, kernel B once a request, no attention kernel
    at all); f32 on the card against the CPU (`compare_f32`); 3 training
    steps (640^2, batch 8, bf16, mosaic on: finite loss, the weights
    moved, no attention kernel); the forward and yolo11's PSA stage timed
    beside yolov12's forward; then `family_commands`. Returns kernel B's
    launches by path."""
    import torch
    from yolou_tpu_torch import kernels
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 41)
    requests = [make_images(rng, BATCH) for _ in range(REQUESTS)]
    weights = {"yolov12": yolov12_state_dict}
    launches, counts, seconds, parts = {}, {}, {}, {}

    def lap(name, t0):
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    for arch in FAMILIES:
        t0 = time.perf_counter()
        weights[arch] = sd = seeded_state_dict(arch)
        t0 = lap("weights (CPU calibration)", t0)
        stats, n = counted(lambda: serve(sd, device, torch.bfloat16,
                                         requests, arch=arch))
        for st in stats:
            log("families", arch=arch, **st)
        log("families", arch=arch, check="serve", launches=n,
            requests=REQUESTS)
        check_launches(f"{arch} serve", forward_launches(n), 0, REQUESTS)
        if min(min(st["detections"]) for st in stats) < 1:
            raise AssertionError(f"{arch}: an image got no detection")
        launches[f"{arch} serve"] = n["greedy_nms"]
        t0 = lap("serve", t0)
        compare_f32(sd, device, requests[0][:2], arch=arch, phase="families")
        t0 = lap("f32 card vs cpu", t0)

        kernels.reset_launch_counts()
        steps, moved, _ = train(sd, arch)
        n = dict(kernels.launch_counts(), backward=kernels.backward_counts())
        for st in steps:
            log("families", arch=arch, check="train", **st)
        log("families", arch=arch, check="train", moved=moved, launches=n)
        check_launches(f"{arch} train", forward_launches(n), 0, 0)
        if any(n["backward"].values()):
            raise AssertionError(f"{arch} train: backward calls {n}")
        lap("train", t0)

    t0 = time.perf_counter()
    family_forwards(device, weights, requests[0])
    t0 = lap("forwards timed", t0)
    for arch in FAMILIES:
        family_commands(device, root, arch, weights[arch], counts, seconds)
        for c in ("predict", "val", "export call"):
            launches[f"{arch} {c}"] = counts[f"{arch} {c}"]["greedy_nms"]
    lap("commands", t0)
    log("families", seconds=time.perf_counter() - t_phase, parts=parts)
    return launches


# ------------------------------------------------------------- sources

CLIP_FRAMES = 24
PIL_IMAGES = 8


def write_clip(path: str, frames: np.ndarray) -> None:
    """`frames` (N, H, W, 3) uint8 BGR as an MJPG `.avi` (cv2.VideoWriter)."""
    import cv2
    h, w = frames.shape[1:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (w, h))
    if not writer.isOpened():
        raise AssertionError(f"cv2.VideoWriter cannot write MJPG to {path}")
    for f in frames:
        writer.write(np.ascontiguousarray(f))
    writer.release()


def result_rows(results) -> np.ndarray:
    """(B, n, 7) rows [box, conf, cls, valid] of Results, as the
    validator's, for `flipped_detections`."""
    out = np.zeros((len(results), max([len(r) for r in results] + [1]), 7),
                   np.float32)
    for i, r in enumerate(results):
        out[i, :len(r), :6] = r.boxes.data
        out[i, :len(r), 6] = 1
    return out


def source_errors() -> dict:
    """The camera, stream and screenshot routes where nothing can feed them
    (no camera, a refused localhost port, no display): the error each
    raises. A screenshot raises RuntimeError without `mss`, and `mss`'s
    own error where it is installed but finds no display."""
    import importlib.util
    from yolou_tpu_torch.engine.predictor import load_source
    want = {"0": RuntimeError, "http://127.0.0.1:9/stream.mjpg": OSError,
            "screen": RuntimeError}
    got = {}
    for source, error in want.items():
        try:
            load_source(source)
        except Exception as e:      # noqa: BLE001 - the type is checked
            got[source] = type(e).__name__
            if not isinstance(e, error) and not (
                    source == "screen"
                    and importlib.util.find_spec("mss") is not None):
                raise AssertionError(f"source {source!r} raised "
                                     f"{type(e).__name__}: {e}") from e
        else:
            raise AssertionError(f"source {source!r} raised nothing")
    return got


def sources_phase(device, state_dict, root: str) -> dict:
    """The Predictor over a 24-frame MJPG `.avi` (frames 640^2, 3-channel
    BGR widened to the 4-channel model by their mean) and over a list of
    8 PIL RGBA images, bf16: the frame and image names, 8 kernel A
    launches a forward and one kernel B launch a chunk; the clip in f32 on
    the card against the CPU (detections equal but for near-ties named by
    `flipped_detections`); the camera, stream and screenshot routes by
    their errors. Returns kernels A's and B's launches by path."""
    import os
    import torch
    from PIL import Image
    from yolou_tpu_torch.engine.predictor import Predictor
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 51)
    imgs = make_images(rng, CLIP_FRAMES)
    clip = os.path.join(root, "clip.avi")
    write_clip(clip, imgs[..., :3])
    predictor = Predictor(build_model(state_dict, device, torch.bfloat16),
                          imgsz=IMGSZ, batch_size=BATCH)
    launches = {}
    chunks = -(-CLIP_FRAMES // BATCH)
    t0 = time.perf_counter()
    res, n = counted(lambda: predictor(clip))
    log("sources", check="video", frames=len(res),
        seconds=time.perf_counter() - t0, launches=n,
        detections=[len(r) for r in res], clip_bytes=os.path.getsize(clip))
    if [r.path for r in res] != [f"{clip}#frame{i}"
                                 for i in range(CLIP_FRAMES)]:
        raise AssertionError(f"video: {[r.path for r in res][:3]} ...")
    if any(r.orig_img.shape != (IMGSZ, IMGSZ, 4) for r in res):
        raise AssertionError("video: a frame is not 640x640x4")
    check_launches("sources video", n, 8 * chunks, chunks)
    if min(len(r) for r in res) < 1:
        raise AssertionError("video: a frame got no detection")
    launches["video"] = n

    pil = [Image.fromarray(a) for a in make_images(rng, PIL_IMAGES)]
    if {p.mode for p in pil} != {"RGBA"}:
        raise AssertionError(f"PIL modes {[p.mode for p in pil]}")
    res, n = counted(lambda: predictor(pil))
    log("sources", check="PIL RGBA", images=len(res), launches=n,
        detections=[len(r) for r in res])
    if [r.path for r in res] != [f"pil_{i}" for i in range(PIL_IMAGES)]:
        raise AssertionError(f"PIL: {[r.path for r in res]}")
    check_launches("sources pil", n, 8, 1)
    launches["pil"] = n

    f32_exact(torch)
    rows = {}
    for dev in (device, "cpu"):
        p = Predictor(build_model(state_dict, dev, torch.float32),
                      imgsz=IMGSZ, batch_size=BATCH)
        rows[str(dev)] = result_rows(p(clip))
    card, cpu = rows[str(device)], rows["cpu"]
    flips = flipped_detections(card, cpu, iou_thres=0.45, conf_thres=0.25)
    log("sources", check="f32 video card vs cpu", frames=CLIP_FRAMES,
        detections_card=int(card[..., 6].sum()),
        detections_cpu=int(cpu[..., 6].sum()),
        flipped=[{"frame": i, "kept_on": d, "decision": kind, "gap": g}
                 for i, d, kind, g in flips], near_tie_tol=1e-4)
    if any(abs(g) > 1e-4 for *_, g in flips):
        raise AssertionError(f"f32 video card vs cpu: detections differ "
                             f"beyond near-ties: {flips}")
    log("sources", check="errors without a device", **source_errors(),
        seconds=time.perf_counter() - t_phase)
    return launches


# ------------------------------------------------------------- parallel

def gathered(mesh, values) -> list:
    """Every rank's list of numbers (the same length on each), in rank
    order."""
    import torch
    from yolou_tpu_torch.parallel import mesh as meshlib
    t = torch.tensor([list(map(float, values))], dtype=torch.float64)
    return meshlib.all_gather_rows(t, mesh).tolist()


def timed_steps(step, n: int = 3) -> list:
    """CUDA-event ms of `n` calls of `step` after one."""
    import torch
    out = []
    for i in range(n + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        end.synchronize()
        if i:
            out.append(start.elapsed_time(end))
    return out


def cpu_state(sd: dict) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def parallel_jobs(state_dict, segpp_sd, mesh=None) -> dict:
    """The `parallel` phase's work, under `mesh` or in one process: (b) one
    f32 detector step at 640^2, global batch 8, mosaic on, with the
    launches it made; the bf16 step timed; (c) one f32 decoder update at
    160^2, global batch 128; (d) an f32 Evaluator over 3 batches of 16 at
    160^2 with HD95, with the launches of each step. Under a mesh also the
    gloo gradient all-reduce alone, timed; each rank's launches and times
    gathered."""
    import torch
    from yolou_tpu_torch.parallel import mesh as meshlib
    f32_exact(torch)
    out = {}
    tr = make_trainer(state_dict, None, torch.float32, BATCH, mesh=mesh)
    batch = make_labelled(np.random.default_rng(SEED + 4), BATCH)
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    (loss, parts), n = counted_step(
        lambda: tr.step(batch, gen, use_mosaic=True))
    out["det"] = {"loss": loss.item(),
                  "parts": {k: v.item() for k, v in parts.items()},
                  "launches": n, "state": cpu_state(tr.model.state_dict()),
                  "ema": cpu_state(tr.ema_variables()),
                  "grad_norm": tr.grad_norm.item()}
    if mesh is not None:
        out["allreduce_ms"] = timed_steps(
            lambda: meshlib.sum_gradients(mesh, tr.params), n=5)
    del tr
    tr = make_trainer(state_dict, None, torch.bfloat16, BATCH, mesh=mesh)
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    out["bf16_step_ms"] = timed_steps(
        lambda: tr.step(batch, gen, use_mosaic=True))
    del tr

    rng = np.random.default_rng(SEED + 61)
    imgs, masks = make_decoder_split(rng, DEC_BATCH)
    side = EVAL_IMGSZ // 8
    oms = (1 / (1 + np.exp(-rng.normal(0, 1, (DEC_BATCH, side, side, 1))))
           ).astype(np.float32)
    dec = decoder_trainer(segpp_sd, None, torch.float32, None, "", mesh=mesh)
    dec.ensure_ready(steps_per_epoch=4)
    (loss, dice), n = counted_step(lambda: dec.step(imgs, masks, oms))
    out["dec"] = {"loss": loss.item(), "dice": dice.item(), "launches": n,
                  "state": cpu_state(dec.model.state_dict())}
    del dec

    ev = build_evaluator(segpp_sd, None, torch.float32, mesh=mesh)
    batches = make_eval_batches(np.random.default_rng(SEED + 7),
                                EVAL_BATCHES, EVAL_BATCH, EVAL_IMGSZ)
    res, n = counted_step(lambda: ev.accumulate(iter(batches),
                                                with_hd95=True))
    out["eval"] = {"metrics": res, "launches": n}
    if mesh is not None:
        keys = ("band_attention", "greedy_nms", "band_attention_train")
        out["ranks"] = gathered(mesh, [
            *(out[p]["launches"].get(k, 0) for p in ("det", "dec", "eval")
              for k in keys),
            out["det"]["launches"]["backward"]["band_attention_train"],
            *out["bf16_step_ms"], *out["allreduce_ms"]])
        out["rank"], out["backend"] = mesh.rank, mesh.backend
    return out


def counted_step(fn):
    """(fn(), the kernels' launches during it with the backward calls), the
    counters set to 0 just before the call and read just after it."""
    import torch
    from yolou_tpu_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    got = fn()
    torch.cuda.synchronize()
    return got, dict(kernels.launch_counts(),
                     backward=kernels.backward_counts())


def parallel_rank(state_dict, segpp_sd) -> dict:
    """One of the `parallel` phase's two ranks (gloo, both on cuda:0)."""
    import torch
    from yolou_tpu_torch.parallel import mesh as meshlib
    mesh = meshlib.make_mesh(2)
    if mesh.device != torch.device("cuda", 0) or mesh.backend != "gloo":
        raise AssertionError(f"rank {mesh.rank}: {mesh}")
    as_tensors = lambda sd: {k: torch.from_numpy(v) for k, v in sd.items()}
    return parallel_jobs(as_tensors(state_dict), as_tensors(segpp_sd), mesh)


def state_close(got: dict, want: dict, rtol: float, atol: float,
                skip=()) -> float:
    """The largest |got - want| beyond atol + rtol |want| over two state
    dicts of arrays (0 where every element is within)."""
    worst = 0.0
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or k.startswith(skip):
            continue
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        worst = max(worst, float((np.abs(g - w) - atol - rtol * np.abs(w))
                                 .max(initial=0.0)))
    return worst


def parallel_phase(device, state_dict, root: str) -> dict:
    """Data parallel on the card at full width, yolov12n-seg: (a) a
    DetectorTrainer over a mesh of one (NCCL) against the mesh-less one,
    one bf16 step each at 640^2, batch 8 (`twin_steps`); (b)-(d) two gloo
    ranks on cuda:0 against this process on the same inputs, f32 (TF32
    off): the detector step (loss rtol 3e-4; parameters, EMA and BatchNorm
    statistics rtol 1e-3 / atol 5e-5; per rank 8 kernel C forward launches
    and 8 backward calls), the decoder update (loss 1e-5 relative, decoder
    parameters 3e-5 absolute, the encoder exact), the Evaluator (dice,
    hd95, precision, recall within 1e-6, n_images exact; per rank 8 kernel
    A and 1 kernel B launches a step); each step's bf16 ms per rank beside
    this process's, the gloo gradient all-reduce alone; (e)
    `train-detector --data-parallel 1` through the dispatcher (one NCCL
    rank) runs, `--data-parallel 2` raises by name on one card. Returns the
    ranks' launches by path."""
    import os
    import torch
    from yolou_tpu_torch.parallel import mesh as meshlib
    t_phase = time.perf_counter()
    f32_exact(torch)
    # (a) a mesh of one over NCCL: every collective skipped
    mesh = meshlib.make_mesh(1)
    try:
        if mesh.backend != "nccl" or mesh.device.type != "cuda":
            raise AssertionError(f"make_mesh(1) on the card: {mesh}")
        a = make_trainer(state_dict, device, torch.bfloat16, BATCH)
        b = make_trainer(state_dict, None, torch.bfloat16, BATCH, mesh=mesh)
        batch = make_labelled(np.random.default_rng(SEED + 4), BATCH)
        twin = twin_steps("parallel", a, b, lambda tr: tr.step(
            batch, torch.Generator(device=tr.device).manual_seed(SEED),
            use_mosaic=True)[0])
        del a, b
    finally:
        mesh.close()

    calib = make_eval_batches(np.random.default_rng(SEED + 7), 1,
                              EVAL_BATCH, EVAL_IMGSZ)[0][0]
    segpp_sd = segpp_state_dict(state_dict, calib)
    one = parallel_jobs(state_dict, segpp_sd)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    two = meshlib.launch(parallel_rank, 2, ["cuda:0", "cuda:0"],
                         cpu_state(state_dict), cpu_state(segpp_sd),
                         timeout=600)
    launch_s = time.perf_counter() - t0
    if (two["rank"], two["backend"]) != (0, "gloo"):
        raise AssertionError(f"ranks: {two['rank']} {two['backend']}")

    # (b) the detector step
    g, w = two["det"], one["det"]
    loss_rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
    parts_rel = max(abs(g["parts"][k] - w["parts"][k]) / abs(w["parts"][k])
                    for k in w["parts"])
    params = state_close(g["state"], w["state"], 1e-3, 5e-5)
    ema = state_close(g["ema"], w["ema"], 1e-3, 5e-5)
    per_rank = np.asarray(two["ranks"])          # rows: ranks
    log("parallel", check="detector step, 2 gloo ranks vs one process",
        loss_two=g["loss"], loss_one=w["loss"], loss_rel=loss_rel,
        parts_rel=parts_rel, loss_rtol=3e-4,
        params_stats_beyond_tol=params, ema_beyond_tol=ema,
        tol="rtol 1e-3 / atol 5e-5", grad_norm_two=g["grad_norm"],
        grad_norm_one=w["grad_norm"],
        launches_per_rank=per_rank[:, 2].tolist(),
        backward_per_rank=per_rank[:, 9].tolist(),
        launches_one=w["launches"])
    if not (loss_rel <= 3e-4 and parts_rel <= 3e-4 and params == 0
            and ema == 0):
        raise AssertionError("detector step on 2 ranks differs from one "
                             "process")
    if not ((per_rank[:, 2] == 8).all() and (per_rank[:, 9] == 8).all()
            and w["launches"]["band_attention_train"] == 8):
        raise AssertionError(f"kernel C per rank: {per_rank[:, [2, 9]]}")

    # (c) the decoder update
    g, w = two["dec"], one["dec"]
    dec_rel = abs(g["loss"] - w["loss"]) / abs(w["loss"])
    dice_rel = abs(g["dice"] - w["dice"]) / max(abs(w["dice"]), 1e-12)
    dec_far = state_close(g["state"], w["state"], 0, 3e-5, skip=("yolo.",))
    enc = [k for k in w["state"] if k.startswith("yolo.")
           and not np.array_equal(g["state"][k], w["state"][k])]
    # the encoder stops at layer 4, before the attention: no kernel runs
    log("parallel", check="decoder update, 2 gloo ranks vs one process",
        loss_two=g["loss"], loss_one=w["loss"], loss_rel=dec_rel,
        dice_rel=dice_rel, tol=1e-5, decoder_beyond_3e_5=dec_far,
        encoder_changed=enc[:3],
        launches_per_rank=per_rank[:, 3:6].tolist(),
        launches_one=w["launches"])
    if not (dec_rel <= 1e-5 and dice_rel <= 1e-5 and dec_far == 0
            and not enc):
        raise AssertionError("decoder update on 2 ranks differs from one "
                             "process")
    if per_rank[:, 3:6].any() or any(forward_launches(w["launches"]).values()):
        raise AssertionError(f"decoder update launches: {per_rank[:, 3:6]}")

    # (d) the Evaluator
    g, w = two["eval"]["metrics"], one["eval"]["metrics"]
    diffs = {k: abs(g[k] - w[k]) for k in ("dice", "hd95", "precision",
                                           "recall")}
    log("parallel", check="Evaluator, 2 gloo ranks vs one process",
        two=g, one=w, diffs=diffs, tol=1e-6,
        band_attention_per_rank=per_rank[:, 6].tolist(),
        greedy_nms_per_rank=per_rank[:, 7].tolist())
    if max(diffs.values()) > 1e-6 or g["n_images"] != w["n_images"]:
        raise AssertionError(f"Evaluator on 2 ranks: {g} vs {w}")
    if not ((per_rank[:, 6] == 8 * EVAL_BATCHES).all()
            and (per_rank[:, 7] == EVAL_BATCHES).all()
            and one["eval"]["launches"]["band_attention"] == 8 * EVAL_BATCHES
            and one["eval"]["launches"]["greedy_nms"] == EVAL_BATCHES):
        raise AssertionError(f"Evaluator launches per rank: "
                             f"{per_rank[:, 6:8]}")

    steps = 3
    log("parallel", check="bf16 detector step ms, 640^2, global batch 8",
        one_process=one["bf16_step_ms"],
        rank0=per_rank[0, 10:10 + steps].tolist(),
        rank1=per_rank[1, 10:10 + steps].tolist(),
        gloo_grad_allreduce_ms=per_rank[:, 10 + steps:].tolist(),
        launch_seconds=launch_s, card=card_line())

    # (e) the command line, over two steps' worth of PNGs
    counts, seconds = {}, {}
    dp = os.path.join(root, "dp")
    yaml = os.path.join(dp, "data.yaml")
    with cv2_blocked():
        rng = np.random.default_rng(SEED + 71)
        write_split(dp, "train", 2 * EVAL_BATCH, rng)
        write_split(dp, "val", EVAL_BATCH, rng)
        with open(yaml, "w") as f:
            f.write(f"path: {dp}\ntrain: images/train\nval: images/val\n"
                    f"channels: 4\nnc: 1\nnames: [\"whole_tumor\"]\n")
        hist, _ = run_command(
            ["train-detector", "--data", yaml, "--model",
             os.path.join(root, "init.ckpt"), "--imgsz", str(EVAL_IMGSZ),
             "--batch", str(EVAL_BATCH), "--epochs", "1", "--run-dir",
             os.path.join(dp, "runs"), "--out", os.path.join(dp, "dp.ckpt"),
             "--dtype", "bfloat16", "--data-parallel", "1"], counts,
            seconds, key="dp1")
        if not (len(hist["loss"]) == 1 and np.isfinite(hist["loss"]).all()
                and os.path.exists(os.path.join(dp, "dp.ckpt"))):
            raise AssertionError(f"--data-parallel 1: {hist}")
        try:
            run_command(["train-detector", "--data", yaml,
                         "--data-parallel", "2"], counts, seconds, key="dp2")
        except RuntimeError as e:
            refused = str(e)
        else:
            raise AssertionError("--data-parallel 2 ran on one card")
    if "--data-parallel 2: one CUDA device a rank" not in refused:
        raise AssertionError(f"--data-parallel 2: {refused}")
    log("parallel", check="train-detector --data-parallel 1 / 2",
        seconds=seconds["dp1"], loss=hist["loss"], refused=refused,
        phase_seconds=time.perf_counter() - t_phase, twin=twin)
    return {"train": int(per_rank[0, 2]), "backward": int(per_rank[0, 9]),
            "evaluate": int(per_rank[0, 6]),
            "evaluate nms": int(per_rank[0, 7])}


# ------------------------------------------------------------- model axis

AXIS_MIN_SIZE = 2 ** 12        # the dry run's rule: 99 weights cut
AXIS_CUT = 99
AXIS_CUT_PARAMS = 2_747_392    # their elements
DEMO_EPOCHS = 6


def axis_spec(state_dict, ckpt_dir: str) -> dict:
    """`tests/torch_parallel_ranks.py::trajectory`'s spec of the
    model_axis phase: yolov12n-seg at 160^2, global batch 16 (the reference
    fine-tune's), mosaic on, 3 seeded steps, the files written before the
    first and after the last, and one more step's batch and seed."""
    rng = np.random.default_rng(SEED + 81)
    return {"state_dict": cpu_state(state_dict),
            "cfg": dict(imgsz=EVAL_IMGSZ, batch_size=EVAL_BATCH, epochs=10,
                        warmup_epochs=3.0),
            "steps_per_epoch": 100, "seed": SEED, "use_mosaic": True,
            "min_size": AXIS_MIN_SIZE, "ckpt_dir": ckpt_dir,
            "batches": [make_labelled(rng, EVAL_BATCH, EVAL_IMGSZ)
                        for _ in range(TRAIN_STEPS)],
            "twin": (make_labelled(rng, EVAL_BATCH, EVAL_IMGSZ), SEED + 1)}


def axis_bf16_step(spec: dict, mesh, device) -> list:
    """A bf16 DetectorTrainer step over the spec's first batch (the weights
    cut under a model axis): CUDA-event ms of 3 steps after one, then the
    host ms of the model group's collectives within each."""
    import torch
    from yolou_tpu_torch.data.augment import AugHyp
    from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                         DetectorTrainer)
    from yolou_tpu_torch.models.yolo import build_yolo
    from yolou_tpu_torch.parallel import mesh as meshlib
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       dtype=torch.bfloat16, device=device)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in spec["state_dict"].items()})
    rules = None
    if mesh is not None and mesh.n_model > 1:
        rules = meshlib.param_sharding_rules(mesh, model, AXIS_MIN_SIZE)
    tr = DetectorTrainer(model, _Data(), DetectorTrainConfig(**spec["cfg"]),
                         aug=AugHyp(), device=device, mesh=mesh,
                         sharding=rules)
    tr.ensure_ready(steps_per_epoch=100)
    gen = torch.Generator(device=tr.device).manual_seed(SEED)
    batch = spec["batches"][0]
    comm = []

    def step():
        before = meshlib.model_comm["seconds"]
        tr.step(batch, gen, use_mosaic=True)
        comm.append(1e3 * (meshlib.model_comm["seconds"] - before))

    return timed_steps(step) + comm[1:]


def wait_for(path: str, alive=lambda: True, timeout: float = 600.0) -> None:
    """Until the file `path` exists; raises once `alive()` is false or after
    `timeout` seconds."""
    import os
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if not alive() or time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"waited for {path}")
        time.sleep(0.05)


def model_axis_rank(spec: dict, n_model: int, gates: str) -> dict:
    """One rank of the model_axis phase (gloo, every rank on cuda:0): the
    f32 trajectory (TF32 off) on a (size / n_model) x n_model mesh; then,
    once the phase's process lets this mesh run alone (`gates`, a directory
    of marker files), the bf16 step timed. Every rank's times come back
    with rank 0's result."""
    import os
    import torch
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.parallel import mesh as meshlib
    from tests import torch_parallel_ranks as ranks
    f32_exact(torch)
    mesh = meshlib.make_mesh(n_model=n_model)
    if mesh.device != torch.device("cuda", 0) or mesh.backend != "gloo":
        raise AssertionError(f"rank {mesh.rank}: {mesh}")
    out = ranks.trajectory(spec, mesh)
    # kernel C's paths since the trajectory's last reset (its last step),
    # then over the bf16 steps
    paths = [kernels.path_counts("band_attention_train")]
    tag = os.path.join(gates, spec["tag"])
    open(f"{tag}.ready{mesh.rank}", "w").close()
    wait_for(f"{tag}.go")
    meshlib.barrier(mesh)
    kernels.reset_launch_counts()
    out["bf16"] = ranks.per_rank(mesh, axis_bf16_step(spec, mesh,
                                                      mesh.device))
    paths.append(kernels.path_counts("band_attention_train"))
    out["train_paths"] = ranks.per_rank(mesh, paths)
    return out


def check_axis_run(name: str, got: dict, one: dict) -> dict:
    """A mesh's trajectory against one process's: the losses and parts
    (rtol 3e-4), the gathered parameters, EMA and BatchNorm statistics
    (rtol 1e-3 / atol 5e-5), the gradient norm (1e-5), and in every rank
    the replicated tensors bit-identical across its model group, 99
    weights cut, the parameter bytes of one process less half the cut
    ones, kernel C 8 + 8 a step."""
    loss_rel = max(abs(g[0] - w[0]) / abs(w[0])
                   for g, w in zip(got["losses"], one["losses"]))
    parts_rel = max(abs(g[1][k] - w[1][k]) / abs(w[1][k])
                    for g, w in zip(got["losses"], one["losses"])
                    for k in w[1])
    params = state_close(cpu_state(got["state_dict"]),
                         cpu_state(one["state_dict"]), 1e-3, 5e-5)
    ema = state_close(cpu_state(got["ema"]), cpu_state(one["ema"]), 1e-3,
                      5e-5)
    norm_rel = max(abs(g - w) / w for g, w in zip(got["grad_norms"],
                                                  one["grad_norms"]))
    one_bytes = one["ranks"][0]["param_bytes"]
    ranks = got["ranks"]
    out = {"loss_rel": loss_rel, "parts_rel": parts_rel,
           "params_stats_beyond_tol": params, "ema_beyond_tol": ema,
           "grad_norm_rel": norm_rel, "grad_norm_rtol": 1e-5,
           "grad_norms": got["grad_norms"],
           "replicas_identical": [r["replicas_identical"] for r in ranks],
           "cut_per_rank": [r["n_cut"] for r in ranks],
           "param_bytes_per_rank": [r["param_bytes"] for r in ranks],
           "param_bytes_one": one_bytes,
           "launches_per_rank": [r["launches"] for r in ranks],
           "train_paths_per_rank": got["train_paths"]}
    log("model_axis", check=f"{name} f32 steps vs one process", **out)
    if not (loss_rel <= 3e-4 and parts_rel <= 3e-4 and params == 0
            and ema == 0 and norm_rel <= 1e-5):
        raise AssertionError(f"{name}: the steps part from one process's")
    if not all(r["replicas_identical"] and r["n_cut"] == AXIS_CUT
               and r["param_bytes"] == one_bytes - 4 * AXIS_CUT_PARAMS // 2
               and [tuple(x) for x in r["launches"]] == [(8, 8)] * TRAIN_STEPS
               for r in ranks):
        raise AssertionError(f"{name}: per rank {ranks}")
    # every kernel C launch of every rank short: f32 in the trajectory's
    # last step(s), bf16 in the timed steps
    if not all(set(f32) == {"short f32"} and set(b16) == {"short bf16"}
               for f32, b16 in got["train_paths"]):
        raise AssertionError(f"{name}: kernel C's paths per rank "
                             f"{got['train_paths']}")
    return out


def model_axis_phase(device, state_dict, root: str) -> dict:
    """The model axis at full width, yolov12n-seg, 160^2, global batch 16,
    mosaic on: (a) 4 gloo ranks on cuda:0 as a 2 x 2 mesh and 2 as a 1 x 2
    mesh, each taking 3 f32 steps (TF32 off) with
    `param_sharding_rules(min_size=2**12)`, against this process on the
    same inputs (`check_axis_run`); one bf16 step each timed per rank, the
    model group's collectives' host ms within it, beside one process's;
    (b) `dryrun_multichip(4)` on cuda:0 x 4, phase 2 within 3e-4, run
    beside the meshes' f32 steps (each mesh's bf16 step is then timed with
    nothing else on the card); (c) the 2 x 2 state file before any step
    byte for byte one process's, and its last.ckpt read by a one-process
    trainer: one more step on both from the same batch and seed within
    `twin_steps`' tolerance. Returns the launches per rank."""
    import os
    import threading
    import torch
    from yolou_tpu_torch.parallel import mesh as meshlib
    from yolou_tpu_torch.tools import dryrun
    from tests import torch_parallel_ranks as ranks
    t_phase = time.perf_counter()
    f32_exact(torch)
    ckpt_dir = os.path.join(root, "model_axis")
    gates = os.path.join(ckpt_dir, "gates")
    os.makedirs(gates, exist_ok=True)
    spec = axis_spec(state_dict, ckpt_dir)
    one = ranks.trajectory(dict(spec, device=device))
    one_bf16 = axis_bf16_step(spec, None, device)
    torch.cuda.empty_cache()
    # the files and the step after them on the 2 x 2 mesh only
    steps_only = {k: v for k, v in spec.items() if k != "twin"}
    steps_only["ckpt_dir"] = None
    meshes = {"2x2": (2, spec), "1x2": (1, steps_only)}
    runs, seconds, failed = {}, {}, {}

    def run(name, n_data, sp):
        t0 = time.perf_counter()
        try:
            runs[name] = meshlib.launch(
                model_axis_rank, 2 * n_data, ["cuda:0"] * 2 * n_data,
                dict(sp, tag=name), 2, gates, timeout=600)
        except BaseException as e:      # re-raised below
            failed[name] = e
        seconds[name] = time.perf_counter() - t0

    threads = {name: threading.Thread(target=run, args=(name, *m))
               for name, m in meshes.items()}
    for t in threads.values():
        t.start()
    try:
        # (b) the dry run, four ranks on the card, beside the f32 steps
        t0 = time.perf_counter()
        dry = dryrun.dryrun_multichip(4, ["cuda:0"] * 4, timeout=600)
        seconds["dryrun"] = time.perf_counter() - t0
        # then each mesh's bf16 step alone on the card: the next mesh
        # goes once the ranks of this one have ended
        for name, (n_data, _) in meshes.items():
            tag = os.path.join(gates, name)
            for r in range(2 * n_data):
                wait_for(f"{tag}.ready{r}", threads[name].is_alive)
            open(f"{tag}.go", "w").close()
            threads[name].join()
    finally:
        for name in meshes:     # never leave a rank waiting
            open(os.path.join(gates, f"{name}.go"), "w").close()
        for t in threads.values():
            t.join()
        if failed:              # the cause, not a wait that it ended
            raise next(iter(failed.values()))
    log("model_axis", check="dryrun_multichip(4) on cuda:0 x 4",
        phase1=dry["phase1"], phase2=dry["phase2"], n_cut=dry["n_cut"],
        rel_diff=dry["rel_diff"], rtol=dryrun.DRYRUN_RTOL,
        seconds=seconds["dryrun"])
    checks = {name: check_axis_run(name, run, one)
              for name, run in runs.items()}
    steps = TRAIN_STEPS
    log("model_axis", check="bf16 detector step ms, 160^2, global batch 16",
        one_process=one_bf16[:steps],
        **{f"{name} rank {r}": row[:steps] for name, run in runs.items()
           for r, row in enumerate(run["bf16"])},
        **{f"{name} rank {r} model-group collectives host ms": row[steps:]
           for name, run in runs.items() for r, row in enumerate(run["bf16"])},
        launch_seconds=seconds, card=card_line())

    # (c) files across meshes
    init = {n: open(os.path.join(ckpt_dir, f"{n}_init.ckpt"), "rb").read()
            for n in ("one", "2x2")}
    if init["one"] != init["2x2"]:
        raise AssertionError("the 2 x 2 state file before any step differs "
                             "from one process's")
    mesh_run = runs["2x2"]
    back = ranks.trajectory(dict(
        spec, device=device, batches=[], ckpt_dir=None,
        resume=os.path.join(ckpt_dir, "2x2_last.ckpt")))
    before = cpu_state(mesh_run["state_dict"])
    a, b = cpu_state(mesh_run["twin_state"]), cpu_state(back["twin_state"])
    keys = [k for k, v in a.items()                 # the parameters
            if v.dtype.kind == "f" and ".running_" not in k]
    upd = max(float(np.abs(a[k] - before[k]).max()) for k in keys)
    diff = max(float(np.abs(a[k] - b[k]).max()) for k in keys)
    la, lb = mesh_run["twin"][0], back["twin"][0]
    twin = {"loss": [la, lb], "max_update": upd, "max_param_diff": diff,
            "init_bytes": len(init["one"])}
    log("model_axis", check="2x2 last.ckpt resumed in one process, one "
        "more step on both", **twin)
    if not (abs(la - lb) <= 1e-3 * abs(la) and diff <= 0.02 * upd):
        raise AssertionError(f"2x2 -> one process: the trainers parted: "
                             f"{twin}")
    log("model_axis", phase_seconds=time.perf_counter() - t_phase,
        launch_seconds=seconds)
    launches = runs["2x2"]["ranks"][0]["launches"][0]
    return {"train": launches[0], "backward": launches[1],
            "train_paths": runs["2x2"]["train_paths"][0],
            "checks": checks, "twin": twin}


def demo_phase(device, root: str):
    """`tools/run_demo.py`'s four stages (each a `python -m yolou_tpu_torch`
    process on the card) on the demo's synthetic set (64 / 16 / 16 at
    160^2, seed 7) at a short schedule: 6 detector epochs (validation every
    3, close mosaic 2) and 6 decoder epochs. Each stage's files, finite
    metrics, the objectmap AUC line, and each stage's launches: kernel C 8
    a step in the fine-tune, each on its short path, kernel A 8 and kernel
    B 1 a batch where a whole model runs, none in the decoder's training
    (its encoder stops before the attention). Returns each stage's launches
    and kernels A and C's launches by path."""
    import os
    from yolou_tpu_torch.tools.run_demo import run_demo
    t0 = time.perf_counter()
    d = os.path.join(root, "demo")
    out = run_demo(d, "cuda", detector_epochs=DEMO_EPOCHS,
                   decoder_epochs=DEMO_EPOCHS, close_mosaic=2, val_every=3)
    steps = DEMO_EPOCHS * (64 // EVAL_BATCH)
    vals = DEMO_EPOCHS // 3
    want = {"train-detector": {"band_attention_train": 8 * steps,
                               "band_attention": 8 * vals,
                               "greedy_nms": vals},
            "generate-objectmaps": {"band_attention": 8 * 3,
                                    "greedy_nms": 0},
            "train-decoder": {"band_attention": 0, "greedy_nms": 0,
                              "band_attention_train": 0},
            "evaluate": {"band_attention": 8, "greedy_nms": 1}}
    got = out["launches"]
    wrong = {s: {k: (got[s][k], n) for k, n in w.items() if got[s][k] != n}
             for s, w in want.items()}
    train_paths = out["paths"]["train-detector"]["band_attention_train"]
    if sum(train_paths.values()) != 8 * steps or not all(
            k.startswith("short ") for k in train_paths):
        wrong["train-detector paths"] = train_paths
    files = [os.path.join(d, "yolo_best.ckpt"),
             os.path.join(d, "runs_dec", "segpp_final.ckpt")]
    maps = {s: len(os.listdir(os.path.join(d, "objectmap", s)))
            for s in ("train", "val", "test")}
    metrics = [v[k] for v in out["validations"] for k in ("map50", "map")]
    metrics += [out["objectmap"]["auc"], out["best_val_dice"]]
    metrics += [out["test"][k] for k in ("dice", "precision", "recall")]
    log("demo", validations=out["validations"], objectmap=out["objectmap"],
        best_val_dice=out["best_val_dice"],
        best_val_dice_epoch=out["best_val_dice_epoch"], test=out["test"],
        stage_seconds=out["stage_seconds"], launches=got,
        paths=out["paths"],
        phase_seconds=time.perf_counter() - t0, card=card_line())
    if any(wrong.values()):
        raise AssertionError(f"demo launches (got, want): {wrong}")
    if not (all(os.path.exists(p) for p in files)
            and maps == {"train": 64, "val": 16, "test": 16}
            and [v["epoch"] for v in out["validations"]] == [3, 6]
            and all(np.isfinite(metrics)) and out["objectmap"]["n_maps"] > 0
            and out["test"]["n_images"] == 16):
        raise AssertionError(f"demo: {out}")
    return got, out["paths"]


def _kernel_name(line: str):
    """The band attention or a2c2f kernel a ptxas or SASS line names, with
    its I/O type and template arguments (token tile or query rows, key
    step or consumer warpgroups, flags), else None: a `_mma_` or `_wgmma_`
    kernel is bf16, the others f32."""
    import re
    m = re.search(r"((?:band_attention_(?:qkv_|stream_|short_|blocked_|"
                  r"cluster_)?(?:padded_)?|a2c2f_|kv_projection_)"
                  r"(?:wgmma_|mma_|f32_)?kernel)(I\S*?EE)?", line)
    if not m:
        return None
    name, targs = m.group(1), m.group(2) or ""
    kind = "bf16" if "mma_" in name else "float"
    return f"{name}<{','.join([kind, *re.findall(r'L[ib](\d+)E', targs)])}>"


def band_attention_build_report(ptxas_log: str, library) -> list:
    """Per band attention and whole-A2C2f kernel instantiation: registers
    and spill bytes from ptxas' report, and its tensor-core instructions in
    the SASS of the built library where the toolkit has `cuobjdump` (else
    None): HMMA (`mma.sync`) and HGMMA (`wgmma`)."""
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
        entry["hmma"] = entry["hgmma"] = None
    if sass is not None:
        for entry in report.values():
            entry["hmma"] = entry["hgmma"] = 0
        name = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = _kernel_name(line)
            elif name in report:
                for op in ("hmma", "hgmma"):
                    if re.search(rf"\b{op.upper()}\b", line):
                        report[name][op] += 1
    return [{"kernel": k, **v} for k, v in sorted(report.items())]


def check_build_report(report: list) -> None:
    """bf16 kernels on the tensor cores, f32 ones on none (no TF32); the
    streamed bf16 attention kernel and the bf16 a2c2f kernel on wgmma only
    (HGMMA, no HMMA)."""
    if not any(e["kernel"].startswith("a2c2f_wgmma_kernel") for e in report):
        raise AssertionError("no bf16 a2c2f kernel in the build report")
    if not any(e["kernel"].startswith("a2c2f_f32_kernel") for e in report):
        raise AssertionError("no f32 a2c2f kernel in the build report")
    if not any("wgmma" in e["kernel"] for e in report):
        raise AssertionError("no wgmma kernel in the build report")
    for name in ("band_attention_short_wgmma_kernel<",
                 "band_attention_short_f32_kernel<",
                 "kv_projection_wgmma_kernel<",
                 "kv_projection_f32_kernel<",
                 "band_attention_blocked_wgmma_kernel<",
                 # f32 heads past 64: the cluster form, native and padded
                 "band_attention_cluster_kernel<float,0>",
                 "band_attention_cluster_kernel<float,1>",
                 # kernel C's heads padded inside the kernel
                 "band_attention_short_padded_wgmma_kernel<",
                 "band_attention_short_padded_f32_kernel<",
                 "band_attention_stream_padded_wgmma_kernel<",
                 "band_attention_stream_padded_kernel<",
                 "band_attention_blocked_padded_wgmma_kernel<",
                 # the a2c2f kernels' blocked form (HD BLOCKED = 0)
                 "a2c2f_wgmma_kernel<bf16,0,",
                 "a2c2f_f32_kernel<float,32,0>",
                 "a2c2f_f32_kernel<float,64,0>"):
        if not any(e["kernel"].startswith(name) for e in report):
            raise AssertionError(f"no {name}...> in the build report")
    for name in ("band_attention_short_wgmma_kernel<",
                 "band_attention_short_f32_kernel<"):
        for project in ("1", "0"):      # kernel A's form and kernel C's
            if not any(e["kernel"].startswith(name)
                       and e["kernel"].endswith(f",{project}>")
                       for e in report):
                raise AssertionError(f"no {name}..., {project}> in the "
                                     f"build report")
    for entry in report:
        log("build", **entry)
        if entry["hmma"] is None:
            continue
        tensor_cores = "<bf16" in entry["kernel"]
        if (entry["hmma"] + entry["hgmma"] > 0) != tensor_cores:
            raise AssertionError(f"{entry['kernel']}: {entry['hmma']} HMMA, "
                                 f"{entry['hgmma']} HGMMA")
        if "wgmma" in entry["kernel"] and (entry["hmma"] or
                                           not entry["hgmma"]):
            raise AssertionError(f"{entry['kernel']}: {entry['hmma']} HMMA, "
                                 f"{entry['hgmma']} HGMMA")


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
    seconds, clock = {}, [time.perf_counter()]

    def mark(phase: str) -> None:
        """The seconds since the last mark, as `phase`'s."""
        now = time.perf_counter()
        seconds[phase] = round(now - clock[0], 3)
        clock[0] = now
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
    check_build_report(band_attention_build_report(ptxas.getvalue(),
                                                   lib_path))
    mark("build")

    attn_cases = check_attention(device)
    train_attn = check_training_attention(device)
    nms = check_nms(device)
    a2c2f = check_a2c2f(device)
    mark("kernels")

    state_dict = seeded_state_dict()
    rng = np.random.default_rng(SEED)
    requests = [make_images(rng, BATCH) for _ in range(REQUESTS)]
    kernels.reset_launch_counts()
    stats = serve(state_dict, device, torch.bfloat16, requests)
    counts = kernels.launch_counts()
    serve_devices = kernels.device_counts()["band_attention"]
    serve_paths = kernels.path_counts()
    for s in stats:
        log("serve", **s)
    forwards = len(requests)
    log("serve", launches=counts, forwards=forwards,
        band_attention_device_kernels=serve_devices,
        band_attention_paths=serve_paths)
    if serve_paths.get("streamed bf16", 0) < 1:
        raise AssertionError(f"no streamed bf16 band (no bf16 k/v "
                             f"projection) while serving: {serve_paths}")
    if counts["band_attention"] != 8 * forwards:
        raise AssertionError(f"band attention launched "
                             f"{counts['band_attention']} times, want "
                             f"{8 * forwards}")
    if counts["greedy_nms"] < 1:
        raise AssertionError("greedy NMS kernel never launched")
    if min(min(s["detections"]) for s in stats) < 1:
        raise AssertionError("an image got no detection")

    compare_f32(state_dict, device, requests[0][:2])
    mark("serve")

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
    mark("train")

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
    mark("profile attention")

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
    mega_forward = compare_mega(state_dict, device, requests)
    mark("serve-mega")
    shapes = shapes_phase(device, state_dict)
    mark("shapes")

    eval_counts, eval_paths = evaluate(state_dict, device)
    mark("evaluate")
    dec = train_decoder_phase(state_dict, device)
    mark("train-decoder")
    ft = finetune_phase(device)
    mark("finetune")
    log("training-state", finetune=ft["training_state"],
        train_decoder=dec["training_state"], card=card_line())
    with tempfile.TemporaryDirectory() as root:
        cli = cli_phase(device, root)
        mark("cli")
        with cv2_blocked():
            exported = export_phase(device, root)
            mark("export")
            profiled = profile_phase(device, root)
            mark("profile")
            visualized = visualize_phase(device, root)
            mark("visualize-logits")
            families = families_phase(device, root, state_dict)
            mark("families")
        sources = sources_phase(device, state_dict, root)
        mark("sources")
        parallel = parallel_phase(device, state_dict, root)
        mark("parallel")
        axis = model_axis_phase(device, state_dict, root)
        mark("model_axis")
        demo, demo_paths = demo_phase(device, root)
        mark("demo")
    log("timing", phase_seconds=seconds, total=round(sum(seconds.values()), 3))
    later = {"export": exported["bf16"], "export f32": exported["f32"],
             "export segpp": exported["segpp"], "profile": profiled,
             "visualize-logits": visualized,
             "sources video": sources["video"], "sources pil": sources["pil"]}

    src = "yolou_tpu_torch/csrc/"
    pallas = "yolou_tpu/ops/pallas_attn.py"
    # the single-head entry at the shape its launches were counted at
    single = train_attn[("profile-single", "bfloat16")]
    keys = ("max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    # each attention row's numbers at one case (its path named), its error
    # the worst of its cases in each type: kernel A's and C's rows over
    # every case, the streamed rows over the cases on the streamed path
    attn_cases = {(name, dtype_name(dt)): r
                  for (name, dt), r in attn_cases.items()}
    multi_head = {k: r for k, r in train_attn.items()
                  if not k[0].endswith("single")}

    def attention_row(cases, at, path=None, dtypes=BOTH):
        errs = {dn: [r["max_abs_err"] for (_, d), r in cases.items()
                     if d == dn and path in (None, r["path"])]
                for dn in dtypes}
        row = cases[at]
        return {**{k: row[k] for k in keys},
                **{k: row[k] for k in (
                    "exp_floor_ms", "projection_ms", "attention_ms",
                    "projection_bound_ms", "projection_bound_by",
                    "attention_bound_ms", "attention_bound_by") if k in row},
                "max_abs_err": max(sum(errs.values(), [])),
                **{f"max_abs_err_{SHORT[dn]}": max(e) if e else None
                   for dn, e in errs.items()},
                "at": f"{at[0]} {at[1]}", "path": row["path"],
                "ms_source": times_source(row)}

    def projection_row(at):
        """The k/v projection (the first device kernel of kernel A's
        streamed path) in `at`'s type at one case; its error v's (its
        output) over every streamed case of that type, and its and the
        library call's times at each."""
        row, dn = attn_cases[at], at[1]
        streamed = {k: r for (k, d), r in attn_cases.items()
                    if d == dn and r["path"] == "streamed"}
        return {"max_abs_err": max(r["v_max_abs_err"]
                                   for r in streamed.values()),
                "ms": row["projection_ms"],
                "plain_ms": row["projection_plain_ms"],
                "bound_ms": row["projection_bound_ms"],
                "bound_by": row["projection_bound_by"],
                "library_ms": row["projection_library_ms"],
                "library": "torch.addmm (TF32 off)" if dn == "float32"
                           else "torch.addmm (bf16)",
                "at": f"{at[0]} {at[1]}",
                "ms_source": times_source(row),
                **{f"ms {k}": r["projection_ms"]
                   for k, r in streamed.items()},
                **{f"bound_ms {k}": r["projection_bound_ms"]
                   for k, r in streamed.items()},
                **{f"library_ms {k}": r["projection_library_ms"]
                   for k, r in streamed.items()}}

    for (case, dn), r in attn_cases.items():
        if r["path"] == "short" and r["max_abs_err"] > SHORT_TOL[dn]:
            raise AssertionError(f"short path {case} {dn}: "
                                 f"{r['max_abs_err']}")
    stream_a = attention_row(attn_cases, ("L6@1280", "bfloat16"), "streamed")
    stream_a32 = attention_row(attn_cases, ("L6@640b16", "float32"),
                               "streamed")
    short_a = attention_row(attn_cases, ("L6@160", "bfloat16"), "short",
                            ("bfloat16",))
    short_a32 = attention_row(attn_cases, ("L8@160", "float32"), "short",
                              ("float32",))
    stream_c = attention_row(multi_head, ("L6@1024", "float32"), "streamed")
    for (case, dn), r in multi_head.items():
        if r["path"] == "short" and not r["max_abs_err"] <= r["tol"]:
            raise AssertionError(f"short kernel C {case} {dn}: "
                                 f"{r['max_abs_err']}")
    turns = ("short_ms", "streamed_ms")
    short_c = {**attention_row(multi_head, ("L6@160", "bfloat16"), "short",
                               ("bfloat16",)),
               **{f"{k} in turns": multi_head[("L6@160", "bfloat16")][k]
                  for k in turns}}
    short_c32 = {**attention_row(multi_head, ("L6@160", "float32"), "short",
                                 ("float32",)),
                 **{f"{k} in turns": multi_head[("L6@160", "float32")][k]
                    for k in turns}}
    axis_f32, axis_bf16 = axis["train_paths"]
    demo_c = demo_paths["train-detector"]["band_attention_train"]
    stream_c16 = {k: v for k, v in multi_head[("L6@1408", "bfloat16")].items()
                  if k not in ("streamed", "path")}
    wide = shapes["wide"]
    wide_a = {dn: {k: v["band_attention"] for k, v in wide.items()
                   if f"wide {SHORT[dn]}" in v.get("paths", {})}
              for dn in BOTH}
    # the shapes phase's launches on the blocked path, by kernel and type:
    # kernel A's in eval, kernel C's in train mode, the a2c2f folds'
    blocked_a, blocked_c = ({dn: {k: v[kernel] for k, v in wide.items()
                                  if f"blocked {SHORT[dn]}" in v.get(
                                      "paths", {}) and v.get(kernel)}
                             for dn in BOTH}
                            for kernel in ("band_attention",
                                           "band_attention_train"))
    blocked_a2c2f = {dn: {k: v["a2c2f"] for k, v in wide.items()
                          if k.startswith("a2c2f c_") and k.endswith(dn)}
                     for dn in BOTH}

    # kernel C at heads it pads itself: the shapes phase's module runs by
    # type, and the training attention's padded cases
    padded_c = {dn: {k: v["band_attention_train"] for k, v in wide.items()
                     if any(p.endswith(f"{SHORT[dn]} padded")
                            for p in v.get("paths", {}))}
                for dn in BOTH}
    case_keys = ("path", "ms", "copies_ms", "plain_ms", "library_ms",
                 "bound_ms", "bound_by", "max_abs_err", "tol")

    def padded_row(name, dn, kernels_):
        cases = {k: r for k, r in train_attn.items()
                 if r["padded"] and k[1] == dn}
        at = ("L8@640 hd48", dn)
        return {"name": name, "route": "cuda", "source": src +
                "band_attention.cu", "replaces": pallas + ":243",
                "device_kernels": kernels_,
                "launches": sum(padded_c[dn].values()),
                "launches_by_path": {f"shapes {k}": v
                                     for k, v in padded_c[dn].items()},
                **attention_row(cases, at, None, (dn,)),
                "copies_ms": cases[at]["copies_ms"],
                "cases": {k[0]: {f: r[f] for f in case_keys}
                          for k, r in cases.items()}}

    def cluster_widths():
        """The f32 cluster form at two heads of 256 and of 512."""
        return {k[0]: {f: r[f] for f in case_keys if f in r}
                for k, r in multi_head.items()
                if k[0] in ("L8@640 hd256", "L8@640 hd512")}

    def blocked_row(name, source, replaces, kernels_, launches, row):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": replaces, "device_kernels": kernels_,
                "launches": sum(launches.values()),
                "launches_by_path": {f"shapes {k}": v
                                     for k, v in launches.items()},
                **row}
    shapes_devices = shapes.pop("device kernels")
    shapes_paths = shapes.pop("kernel A paths")["yolov12s f32 640"]
    print(json.dumps({"kernels": [
        {"name": "band_attention", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "launches": counts["band_attention"],
         "device_launches": serve_devices,
         **attention_row(attn_cases, ("L6@640", "bfloat16")),
         "attention_library_ms":
             attn_cases[("L6@640", "bfloat16")]["attention_library_ms"],
         "launches_by_path": {
             "serve": counts["band_attention"],
             "evaluate": eval_counts["band_attention"],
             **{k: v["band_attention"] for k, v in dec["launches"].items()},
             "validate": ft["validate"]["band_attention"],
             **{f"cli {k}": v["band_attention"] for k, v in cli.items()
                if isinstance(v, dict)},
             **{k: v["band_attention"] for k, v in later.items()},
             "parallel evaluate (each rank)": parallel["evaluate"],
             **{f"demo {k}": v["band_attention"] for k, v in demo.items()},
             **{f"shapes {k}": v["band_attention"] for k, v in
                shapes.items() if k not in ("residual", "wide")},
             "shapes residual A2C2f bf16":
                 shapes["residual"]["eval"]["band_attention"]},
         "device_launches_by_path": {"serve": serve_devices,
                                     **{f"shapes {k}": v for k, v in
                                        shapes_devices.items()}},
         "backward_calls": dec["attention_backward_calls"]},
        {"name": "band_attention_streamed", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "device_kernels": ["kv_projection_wgmma_kernel",
                            "band_attention_stream_wgmma_kernel<NC, true>"],
         "launches": shapes["yolov12s bf16 1280"]["band_attention"],
         "device_launches": shapes_devices["yolov12s bf16 1280"],
         **stream_a,
         "attention_library_ms":
             attn_cases[("L6@1280", "bfloat16")]["attention_library_ms"]},
        {"name": "band_attention_streamed_f32", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "device_kernels": ["kv_projection_f32_kernel",
                            "band_attention_stream_kernel<R, true>"],
         "launches": shapes["yolov12s f32 640"]["band_attention"],
         "device_launches": shapes_devices["yolov12s f32 640"],
         **stream_a32,
         "attention_library_ms":
             attn_cases[("L6@640b16", "float32")]["attention_library_ms"]},
        {"name": "kv_projection_bf16", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "device_kernels": ["kv_projection_wgmma_kernel"],
         "launches": serve_paths.get("streamed bf16", 0),
         "launches_by_path": {
             "serve": serve_paths.get("streamed bf16", 0),
             # a streamed launch is two device kernels, the others one
             "shapes yolov12s bf16 1280":
                 shapes_devices["yolov12s bf16 1280"]
                 - shapes["yolov12s bf16 1280"]["band_attention"]},
         **projection_row(("L6@640", "bfloat16"))},
        {"name": "kv_projection_f32", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "device_kernels": ["kv_projection_f32_kernel"],
         "launches": shapes_paths.get("streamed f32", 0),
         **projection_row(("L6@640b16", "float32"))},
        {"name": "band_attention_wide", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "device_kernels": ["kv_projection_wgmma_kernel (q | k | v)",
                            "band_attention_stream_wgmma_kernel<NC, false>"],
         "launches": sum(wide_a["bfloat16"].values()),
         "launches_by_path": {f"shapes {k}": v
                              for k, v in wide_a["bfloat16"].items()},
         **attention_row(attn_cases, ("c_928 h29", "bfloat16"), "wide",
                         ("bfloat16",)),
         "hd64": attention_row(attn_cases, ("AAttn(512,8)", "bfloat16"),
                               "wide", ("bfloat16",)),
         "attention_library_ms":
             attn_cases[("c_928 h29", "bfloat16")]["attention_library_ms"]},
        {"name": "band_attention_wide_f32", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":357",
         "device_kernels": ["kv_projection_f32_kernel (q | k | v)",
                            "band_attention_stream_kernel<R, false>"],
         "launches": sum(wide_a["float32"].values()),
         "launches_by_path": {f"shapes {k}": v
                              for k, v in wide_a["float32"].items()},
         **attention_row(attn_cases, ("c_1344 h42", "float32"), "wide",
                         ("float32",)),
         "hd64": attention_row(attn_cases, ("AAttn(640,10)", "float32"),
                               "wide", ("float32",)),
         "attention_library_ms":
             attn_cases[("c_1344 h42", "float32")]["attention_library_ms"]},
        {"name": "band_attention_short", "route": "cuda",
         "source": src + "band_attention_short.cu",
         "replaces": pallas + ":357",
         "device_kernels": ["band_attention_short_wgmma_kernel<HD>"],
         "launches": eval_paths["bf16"].get("short bf16", 0),
         "launches_by_path": {"evaluate": eval_paths["bf16"]},
         **short_a,
         "attention_library_ms":
             attn_cases[("L6@160", "bfloat16")]["attention_library_ms"]},
        {"name": "band_attention_short_f32", "route": "cuda",
         "source": src + "band_attention_short.cu",
         "replaces": pallas + ":357",
         "device_kernels": ["band_attention_short_f32_kernel<HD>"],
         "launches": eval_paths["f32"].get("short f32", 0),
         "launches_by_path": {"evaluate f32 step": eval_paths["f32"]},
         **short_a32,
         "attention_library_ms":
             attn_cases[("L8@160", "float32")]["attention_library_ms"]},
        {"name": "greedy_nms", "route": "cuda",
         "source": src + "greedy_nms.cu",
         "replaces": "yolou_tpu/ops/pallas_nms.py:97",
         "launches": counts["greedy_nms"], **{k: nms[k] for k in keys},
         **{k: nms[k] for k in ("chain_floor_ms", "chain_hops",
                                "one_image_ms")},
         "ms_source": times_source(nms),
         "launches_by_path": {
             "serve": counts["greedy_nms"],
             "evaluate": eval_counts["greedy_nms"],
             **{k: v["greedy_nms"] for k, v in dec["launches"].items()},
             "validate": ft["validate"]["greedy_nms"],
             **{f"cli {k}": v["greedy_nms"] for k, v in cli.items()
                if isinstance(v, dict)},
             **{k: v["greedy_nms"] for k, v in later.items()},
             **{f"families {k}": v for k, v in families.items()},
             "parallel evaluate (each rank)": parallel["evaluate nms"],
             **{f"demo {k}": v["greedy_nms"] for k, v in demo.items()}}},
        {"name": "band_attention_train", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":243",
         "launches": train_launches,
         "backward_calls": train_backwards,
         "launches_by_path": {"train": train_launches,
                              "finetune": ft["train"],
                              "cli train-detector": cli["train"],
                              "parallel step (each rank)": parallel["train"],
                              "model_axis step (each rank)": axis["train"],
                              "demo train-detector":
                                  demo["train-detector"][
                                      "band_attention_train"]},
         "backward_calls_by_path": {"train": train_backwards,
                                    "finetune": ft["backward"],
                                    "cli train-detector": cli["backward"],
                                    "parallel step (each rank)":
                                        parallel["backward"],
                                    "model_axis step (each rank)":
                                        axis["backward"]},
         **attention_row(multi_head, ("L6@640", "bfloat16"))},
        {"name": "band_attention_train_streamed", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":243",
         "device_kernels": ["band_attention_stream_kernel<R, false>",
                            "band_attention_stream_wgmma_kernel<NC, false>"],
         "bf16 L6@1408": stream_c16,
         "launches": shapes["yolov12n train f32 1024"]["band_attention_train"],
         "backward_calls": shapes["yolov12n train f32 1024"]["backward"],
         "launches_by_path": {
             "shapes residual A2C2f f32 train":
                 shapes["residual"]["train"]["band_attention_train"]},
         **stream_c},
        {"name": "band_attention_train_short", "route": "cuda",
         "source": src + "band_attention_short.cu",
         "replaces": pallas + ":243",
         "device_kernels": ["band_attention_short_wgmma_kernel<HD, false>"],
         "launches": ft["train_paths"].get("short bf16", 0),
         "launches_by_path": {
             "finetune": ft["train_paths"],
             "model_axis bf16 steps (rank 0 of 2 x 2)": axis_bf16,
             "demo train-detector": demo_c},
         **short_c},
        {"name": "band_attention_train_short_f32", "route": "cuda",
         "source": src + "band_attention_short.cu",
         "replaces": pallas + ":243",
         "device_kernels": ["band_attention_short_f32_kernel<R, HD, false>"],
         "launches": demo_c.get("short f32", 0),
         "launches_by_path": {
             "demo train-detector": demo_c,
             "model_axis f32 last step and the one after (rank 0 of 2 x 2)":
                 axis_f32},
         **short_c32},
        {"name": "band_attention_single", "route": "cuda",
         "source": src + "band_attention.cu", "replaces": pallas + ":120",
         "launches": profile_counts["band_attention_single"],
         **{k: single[k] for k in keys}, "ms_source": times_source(single)},
        {"name": "a2c2f", "route": "cuda", "source": src + "a2c2f_bf16.cu",
         "replaces": "yolou_tpu/ops/pallas_a2c2f.py:192",
         "launches": mega_counts["a2c2f"],
         "launches_by_path": {
             "serve-mega": mega_counts["a2c2f"],
             "shapes yolov12l f32": shapes["yolov12l mega f32 640"]["a2c2f"]},
         "device_kernels": ["a2c2f_wgmma_kernel<HD, L2>"],
         "mega_forward": mega_forward,
         "staged_ms": a2c2f["bfloat16"]["staged_ms"],
         **{k: a2c2f["bfloat16"][k] for k in keys},
         "ms_source": times_source(a2c2f["bfloat16"])},
        {"name": "a2c2f_wide_mlp", "route": "cuda",
         "source": src + "a2c2f_bf16.cu",
         "replaces": "yolou_tpu/ops/pallas_a2c2f.py:192",
         "device_kernels": ["a2c2f_wgmma_kernel<HD, L2> (h in global "
                            "memory)"],
         "launches": wide["A2C2f(512,512) mlp4 mega"]["a2c2f"],
         "launches_by_path": {"shapes A2C2f(512,512) mlp4 mega":
                              wide["A2C2f(512,512) mlp4 mega"]["a2c2f"]},
         "at": "mlp4 (1,20,20,512) c_256 bfloat16",
         "staged_ms": a2c2f["wide mlp"]["staged_ms"],
         **{k: a2c2f["wide mlp"][k] for k in keys},
         "ms_source": times_source(a2c2f["wide mlp"])},
        {"name": "a2c2f_f32", "route": "cuda", "source": src + "a2c2f_f32.cu",
         "replaces": "yolou_tpu/ops/pallas_a2c2f.py:192",
         "device_kernels": ["a2c2f_f32_kernel<TM, HD>"],
         "launches": shapes["yolov12l mega f32 640"]["a2c2f"],
         "launches_by_path": {
             "shapes yolov12l f32": shapes["yolov12l mega f32 640"]["a2c2f"]},
         "at": "l L8@640 float32",
         "staged_ms": a2c2f["float32"]["staged_ms"],
         **{k: a2c2f["float32"][k] for k in keys},
         "ms_source": times_source(a2c2f["float32"])},
        # heads wider than 64: the blocked path (score work 2x the head's
        # at heads of 128, the rows' width)
        blocked_row("band_attention_blocked", "band_attention.cu",
                    pallas + ":357",
                    ["kv_projection_wgmma_kernel (q | k | v)",
                     "band_attention_blocked_wgmma_kernel"],
                    blocked_a["bfloat16"],
                    {**attention_row(attn_cases, ("L8@640 hd128",
                                                  "bfloat16"), "blocked",
                                     ("bfloat16",)),
                     "attention_library_ms": attn_cases[(
                         "L8@640 hd128", "bfloat16")][
                             "attention_library_ms"]}),
        blocked_row("band_attention_blocked_f32", "band_attention.cu",
                    pallas + ":357",
                    ["kv_projection_f32_kernel (q | k | v)",
                     "band_attention_cluster_kernel<false>"],
                    blocked_a["float32"],
                    {**attention_row(attn_cases, ("L8@640 hd128",
                                                  "float32"), "blocked",
                                     ("float32",)),
                     "attention_library_ms": attn_cases[(
                         "L8@640 hd128", "float32")][
                             "attention_library_ms"]}),
        blocked_row("band_attention_train_blocked", "band_attention.cu",
                    pallas + ":243", ["band_attention_blocked_wgmma_kernel"],
                    blocked_c["bfloat16"],
                    attention_row(multi_head, ("L8@640 hd128", "bfloat16"),
                                  "blocked", ("bfloat16",))),
        blocked_row("band_attention_train_blocked_f32", "band_attention.cu",
                    pallas + ":243", ["band_attention_cluster_kernel<false>"],
                    blocked_c["float32"],
                    {**attention_row(multi_head, ("L8@640 hd128", "float32"),
                                     "blocked", ("float32",)),
                     "wider": cluster_widths()}),
        padded_row("band_attention_train_padded", "bfloat16",
                   ["band_attention_short_padded_wgmma_kernel<HD>",
                    "band_attention_stream_padded_wgmma_kernel<NC, HD>",
                    "band_attention_blocked_padded_wgmma_kernel"]),
        padded_row("band_attention_train_padded_f32", "float32",
                   ["band_attention_short_padded_f32_kernel<R, HD>",
                    "band_attention_stream_padded_kernel<R, HD>",
                    "band_attention_cluster_kernel<true>"]),
        blocked_row("a2c2f_blocked", "a2c2f_bf16.cu",
                    "yolou_tpu/ops/pallas_a2c2f.py:192",
                    ["a2c2f_wgmma_kernel<BLOCKED, L2>"],
                    blocked_a2c2f["bfloat16"],
                    {**{k: wide["a2c2f bfloat16"][k] for k in keys},
                     "at": "c_256 h2 (8,20,20,512) bfloat16",
                     "ms_source": times_source(wide["a2c2f bfloat16"])}),
        blocked_row("a2c2f_blocked_f32", "a2c2f_f32.cu",
                    "yolou_tpu/ops/pallas_a2c2f.py:192",
                    ["a2c2f_f32_kernel<TM, BLOCKED>"],
                    blocked_a2c2f["float32"],
                    {**{k: wide["a2c2f float32"][k] for k in keys},
                     "at": "c_256 h2 (8,20,20,512) float32",
                     "ms_source": times_source(wide["a2c2f float32"])}),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
