#!/usr/bin/env python3
"""Smoke run of the PyTorch port (yolou_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Phases, one output line each:
  1. device  - the card (nvidia-smi name and power limit), torch and CUDA;
  2. build   - nvcc builds the kernels from yolou_tpu_torch/csrc;
  3. kernels - each CUDA kernel against its plain PyTorch version on the card,
               at the serving path's shapes, with CUDA-event times of both;
  4. serve   - a Predictor with seeded random yolov12n-seg weights (4 ch,
               nc=1, 640^2, bf16) answers 3 requests of 8 uint8 images; the
               kernels' launch counters must show the path went through them;
               then the same weights in f32 on the card and on the CPU must
               agree.
Then a JSON line of kernel results, the nvidia-smi line again, and last
{"ok": true, "device": {...}}. Any failure raises: exit code non-zero and no
"ok" line. Without a CUDA device it exits with code 2.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
IMGSZ = 640
BATCH = 8
REQUESTS = 3
ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
BN_STD = 0.1


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
    around `iters` back-to-back calls, after `warmup` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def f32_exact(torch) -> None:
    """Full-f32 matmuls and convolutions (no TF32) for exact comparisons."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------- kernel A

def check_attention(device):
    import torch
    from yolou_tpu_torch.kernels.attention import (
        area_attention_qkv_fused, area_attention_qkv_fused_plain)
    f32_exact(torch)
    cases = [("L6@640", 4 * BATCH, 400, 64, 2), ("L8@640", BATCH, 400, 128, 4),
             ("L6@160", 4 * BATCH, 25, 64, 2), ("L8@160", BATCH, 25, 128, 4)]
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
            tol = ATTN_TOL[str(dtype).split(".")[-1]]
            finite = bool(torch.isfinite(o).all() and torch.isfinite(v).all())
            ms = cuda_ms(lambda: area_attention_qkv_fused(xt, wt, bt, heads))
            plain_ms = cuda_ms(
                lambda: area_attention_qkv_fused_plain(xt, wt, bt, heads))
            log("kernel", name="band_attention", case=name,
                shape=f"({g},{n},{c})h{heads}", dtype=str(dtype)[6:],
                max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms)
            if not finite or not err <= tol:
                raise AssertionError(f"band attention {name} {dtype}: "
                                     f"max|d| {err} > {tol} or non-finite")
            worst = max(worst, err)
            times[(name, dtype)] = (ms, plain_ms)
    return worst, times[("L6@640", torch.bfloat16)]


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
    ms = cuda_ms(lambda: suppress_greedy(bt, vt, 0.45))
    plain_ms = cuda_ms(lambda: suppress_greedy_plain(bt, vt, 0.45))
    log("kernel", name="greedy_nms", case="serve", shape=f"({BATCH},{k})",
        ms=ms, plain_ms=plain_ms)
    return worst, (ms, plain_ms)


# ------------------------------------------------------------- serving

def make_images(rng, count: int, hw: int = IMGSZ) -> np.ndarray:
    """Bright ellipses on dark noise, uint8 (count, hw, hw, 4)."""
    imgs = rng.normal(40, 12, (count, hw, hw, 4)).clip(0, 255)
    yy, xx = np.mgrid[:hw, :hw]
    for i in range(count):
        for _ in range(rng.integers(1, 4)):
            cy, cx = rng.uniform(0.2 * hw, 0.8 * hw, 2)
            ry, rx = rng.uniform(0.04 * hw, 0.15 * hw, 2)
            inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
            imgs[i][inside] = rng.uniform(180, 255, 4)
    return imgs.astype(np.uint8)


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
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment", seed=SEED)
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


def build_model(state_dict, device, dtype):
    from yolou_tpu_torch.models.yolo import build_yolo
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       dtype=dtype, device=device)
    model.load_state_dict(state_dict, strict=True)
    return model


def serve(state_dict, device, dtype, requests):
    """Drive the Predictor over `requests` (list of uint8 stacks); returns
    per-request detections and times."""
    import torch
    from yolou_tpu_torch.engine.predictor import Predictor
    predictor = Predictor(build_model(state_dict, device, dtype), imgsz=IMGSZ,
                          batch_size=BATCH)
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
    lib_path = build.build(verbose=True)
    build.load()
    log("build", seconds=round(time.perf_counter() - t0, 3),
        library=lib_path.name)

    attn_err, (attn_ms, attn_plain_ms) = check_attention(device)
    nms_err, (nms_ms, nms_plain_ms) = check_nms(device)

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

    src = "yolou_tpu_torch/csrc/"
    print(json.dumps({"kernels": [
        {"name": "band_attention", "route": "cuda",
         "source": src + "band_attention.cu",
         "replaces": "yolou_tpu/ops/pallas_attn.py:357",
         "launches": counts["band_attention"], "max_abs_err": attn_err,
         "ms": attn_ms, "plain_ms": attn_plain_ms},
        {"name": "greedy_nms", "route": "cuda",
         "source": src + "greedy_nms.cu",
         "replaces": "yolou_tpu/ops/pallas_nms.py:97",
         "launches": counts["greedy_nms"], "max_abs_err": nms_err,
         "ms": nms_ms, "plain_ms": nms_plain_ms},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
