"""Time the paths of the band attention kernels against each other, on one
GPU, at every band of yolov12 n-x: the short path at each tile's row count
and the streamed one at each number of query rows a CTA may take.

    python -m yolou_tpu_torch.tools.attention_routes [--out F] [--iters N]
        [--kernels AC] [--summarize F]

Kernels A (`area_attention_qkv_fused`) and C (`area_attention_fused`) each
have a short path at bands of 64 tokens or fewer (whole bands packed to a
tile of 64 rows, or in float32 32 where N <= 32; one launch, both types)
and a streamed one (key tiles through shared memory, CTAs of 128 or 64
query rows in bfloat16, 64, 32 or 16 in float32); see
`kernels/attention.py::attention_plan`, whose choices rest on these times.
For each band (layers 6 and 8 of every yolov12 scale at 160^2-1280^2,
batch 1 and 8; 160^2 also at batch 16, the evaluator's and the fine-tune's,
8, a data shard of the fine-tune's 2 x 2 mesh, and 128, the objectmap
generator's) and each type, every path the band can take is forced in
turns (each in order, then in reverse) on the same seeded inputs, each
turn the card's own time per call (`profile_layers.device_ms`,
torch.profiler, `--iters` calls after 3 warm-up calls). `--kernels A` or
`C` times one kernel's bands only. Prints the card's name and power limit,
then one JSON object: {"card": ..., "rows": [{"kernel", "dtype", "g", "n",
"c", "heads", "short_ms": {rows: [2 turns]} or null, "streamed_ms": {rows:
[2 turns]}, "plan": "short" or "streamed", "plan_rows": ...}, ...],
"summary": ...}; "plan" and "plan_rows" are what `attention_plan` takes,
"summary" is `summarize`'s (the plan against the fastest path, the short
path against the best streamed one), which `--summarize F` prints again
from an earlier `--out F`, beside the same with the plan `attention_plan`
makes now (a refitted rule's cost on the timings it was fitted to).
"""

from __future__ import annotations

import argparse
import itertools
import json
from pathlib import Path

import numpy as np
import torch

from ..kernels.attention import (_SHORT_ROWS, _launch_band_attention,
                                 _launch_qkv_attention, attention_plan)
from .profile_layers import card_name_and_power_limit, device_ms

# yolov12's attention widths at layers 6 and 8 (AAttn's dim), n-x
WIDTHS = ((64, 128), (128, 256), (256, 256), (256, 256), (384, 384))
SIZES = (160, 320, 480, 640, 800, 960, 1120, 1280)


def bands():
    """(G, N, C, heads) of every yolov12 band above, each once."""
    out = []
    for c6, c8 in WIDTHS:
        for imgsz in SIZES:
            batches = (1, 8, 16, 128) if imgsz == 160 else (1, 8)
            for batch in batches:
                for c, stride, area in ((c6, 16, 4), (c8, 32, 1)):
                    tokens = (imgsz // stride) ** 2
                    n = tokens // area if tokens % area == 0 else tokens
                    g = batch * (area if tokens % area == 0 else 1)
                    band = (g, n, c, c // 32)
                    if band not in out:
                        out.append(band)
    return out


STREAM_ROWS = {torch.bfloat16: (128, 64), torch.float32: (64, 32, 16)}
SHORT_ROWS = {torch.bfloat16: (64,), torch.float32: (64, 32)}


def time_routes(iters: int = 20, device: str = "cuda", kernels: str = "AC"):
    """The rows described above, of the kernels named in `kernels`."""
    rng = np.random.default_rng(0)

    def mk(shape, dtype, std=1.0):
        return torch.from_numpy(rng.normal(0, std, shape).astype(
            np.float32)).to(device, dtype)

    rows = []
    for projection, dtype in itertools.product(
            (True, False), (torch.bfloat16, torch.float32)):
        if ("A" if projection else "C") not in kernels:
            continue
        for g, n, c, heads in bands():
            # a path: (name, CTA or tile rows)
            if projection:
                x = mk((g, n, c), dtype)
                w = mk((c, 3 * c), dtype, 0.5 / np.sqrt(c))
                b = torch.zeros(3 * c, device=device)

                def run(path):
                    return lambda: _launch_qkv_attention(x, w, b, heads,
                                                         *path)
            else:
                q, k, v = (mk((g, n, c), dtype) for _ in range(3))

                def run(path):
                    return lambda: _launch_band_attention(q, k, v, heads,
                                                          *path)
            paths = [("streamed", r) for r in STREAM_ROWS[dtype]]
            if n <= _SHORT_ROWS:
                paths[:0] = [("short", r) for r in SHORT_ROWS[dtype]
                             if n <= r]
            times = {path: [] for path in paths}
            with torch.no_grad():
                for path in paths + paths[::-1]:
                    times[path].append(device_ms(run(path), iters))
            plan = attention_plan(g, n, c, dtype, projection)
            rows.append({
                "kernel": "A" if projection else "C",
                "dtype": str(dtype).split(".")[-1], "g": g, "n": n, "c": c,
                "heads": heads,
                "short_ms": {str(r): times[(name, r)] for name, r in times
                             if name == "short"} or None,
                "streamed_ms": {str(r): times[("streamed", r)]
                                for r in STREAM_ROWS[dtype]},
                "plan": plan.path, "plan_rows": plan.rows})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def summarize(rows, replan: bool = False) -> dict:
    """Per kernel and type: the plan's time over the fastest path's at each
    band (mean and worst, each path's time the mean of its turns; with
    `replan`, the plan `attention_plan` makes now in place of the one
    recorded), and at the bands of 64 tokens or fewer how many the short
    path (its faster row count) wins against the best streamed row count,
    and its worst time over that streamed one's."""
    out = {}
    for row in rows:
        if replan:
            plan = attention_plan(row["g"], row["n"], row["c"],
                                  getattr(torch, row["dtype"]),
                                  row["kernel"] == "A")
            row = {**row, "plan": plan.path, "plan_rows": plan.rows}
        times = {}
        for r, t in (row["short_ms"] or {}).items():
            times[("short", int(r))] = np.mean(t)
        for r, t in row["streamed_ms"].items():
            times[("streamed", int(r))] = np.mean(t)
        best = min(times.values())
        plan = times[(row["plan"], row["plan_rows"])]
        key = f"{row['kernel']} {row['dtype']}"
        s = out.setdefault(key, {"bands": 0, "plan_over_best": [],
                                 "short_bands": 0, "short_wins": 0,
                                 "short_over_streamed_worst": 0.0})
        s["bands"] += 1
        s["plan_over_best"].append(plan / best)
        if row["short_ms"]:
            short = min(np.mean(t) for t in row["short_ms"].values())
            streamed = min(np.mean(t) for t in row["streamed_ms"].values())
            s["short_bands"] += 1
            s["short_wins"] += int(short < streamed)
            s["short_over_streamed_worst"] = max(
                s["short_over_streamed_worst"], short / streamed)
    for s in out.values():
        ratios = s.pop("plan_over_best")
        s["plan_over_best_mean"] = float(np.mean(ratios))
        s["plan_over_best_worst"] = float(np.max(ratios))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", type=Path, default=None,
                   help="also write the JSON object to this file")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--kernels", default="AC",
                   help="the kernels whose bands to time: A, C or AC")
    p.add_argument("--summarize", type=Path, default=None,
                   help="only print `summarize` of this earlier --out file, "
                        "as recorded and with today's plan")
    args = p.parse_args(argv)
    if args.summarize:
        rows = json.loads(args.summarize.read_text())["rows"]
        print(json.dumps({"recorded": summarize(rows),
                          "replanned": summarize(rows, replan=True)},
                         indent=1))
        return 0
    card = card_name_and_power_limit()
    print(card, flush=True)
    rows = time_routes(args.iters, kernels=args.kernels)
    result = {"card": card, "rows": rows, "summary": summarize(rows)}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
