"""Run one cell of the benchmark of `yolou_tpu_torch` and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell (`BENCHMARK.json`'s `workloads`)
names a configuration (`benchmark/configs/<name>.json`) and a traffic mix
(`benchmark/traffic/<name>.json`, whose `driver` is a module of
`benchmark/drivers/`); its limits are `benchmark/cells/<cell>.json`; each
per-layer metric is read by `benchmark/metrics/<metric>.py`. Adding a
cell, configuration, traffic mix or metric adds files and edits none.

A run: the card's line from `nvidia-smi`; set-up (weights and inputs made
on the card from the seed, the program built, every shape of the window
warmed), whose seconds from the process's start are `setup_s` (`device`'s
`cold` says whether set-up compiled anything); the driver's window of
`--seconds` and its end-to-end statistics; with `--trace 1`, a profiled
stretch of a few requests after it; the peak memory; the program freed;
the check against the plain reference; the check that no JAX module was
loaded. The last line of standard output is the result; the numbers
compared, each with its limit, are the last lines of standard error and
the result's last key. It fails, printing no result, without enough CUDA
cards or where JAX or the JAX package was imported.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
BENCH = Path(__file__).resolve().parent
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "yolou_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (Linux)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: `yolou_tpu_torch` is not `yolou_tpu`)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(workload: str, manifest: dict) -> Dict[str, object]:
    """The cell's entry and every file it names."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; have "
                         f"{sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}
    cfg = load_json(ROOT / configs[cell["config"]]["file"])
    traffic = load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH / "cells" / f"{workload}.json")["limits"]
    return {"cell": cell, "config": cfg, "traffic": traffic,
            "limits": limits}


def cell_metrics(manifest: dict, workload: str, table: str) -> List[dict]:
    """The metrics of `table` ("end_to_end", "per_layer") this cell
    reports."""
    return [m for m in manifest[table]
            if workload in m.get("workloads", [workload])]


def build_files() -> set:
    """The program's built libraries and the benchmark's kernel caches: a
    run that adds to them compiled in its set-up (`device["cold"]`)."""
    return {p for d in (ROOT / "yolou_tpu_torch" / "_build", CACHE)
            if d.is_dir() for p in d.rglob("*") if p.is_file()}


def reader(metric: str):
    """`benchmark/metrics/<metric>.py`'s `read`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, start: float, manifest: dict,
             overrides: Optional[dict] = None) -> dict:
    """One run of `workload` on `device` (a torch.device; "cpu" and
    `overrides` of the configuration's and the traffic's keys, for smaller
    sizes, only in the benchmark's own tests). Returns the result."""
    import torch
    from . import card, roofline
    files = cell_files(workload, manifest)
    overrides = overrides or {}
    cfg = {**files["config"], **overrides.get("config", {})}
    traffic = {**files["traffic"], **overrides.get("traffic", {})}
    limits = files["limits"]
    torch.backends.cudnn.allow_tf32 = cfg["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["matmul_tf32"]
    driver_mod = importlib.import_module(
        f"benchmark.drivers.{traffic['driver']}")
    built = build_files()
    drv = driver_mod.Driver(cfg, traffic, seed, device)
    drv.warm()
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    setup_s = time.time() - start
    cold = build_files() != built

    win = drv.window(traffic["warmup_requests"], seconds)

    metrics: Dict[str, dict] = {}
    breakdown = None
    device_rec: Dict[str, object] = {}
    if trace:
        from .trace import Trace, profile_requests
        n = traffic["profiled_requests"]
        tr = Trace(profile_requests(
            lambda k: (drv.request(k), drv.sync()), win.next, n), n)
        ctx = {"trace": tr, "images_per_request": drv.images_per_request,
               "window_s": win.wall_s, "requests": win.requests,
               "flops_per_request": drv.flops_per_request(),
               "peak": roofline.peak_name(cfg["dtype"], cfg["cudnn_tf32"])}
        for m in cell_metrics(manifest, workload, "per_layer"):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown()
        device_rec = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        stats = drv.statistics(win)
        for m in cell_metrics(manifest, workload, "end_to_end"):
            value = (setup_s if m["name"] == "setup_s"
                     else stats[traffic["end_to_end"][m["name"]]])
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec["cold"] = cold
    if on_card:
        line = card.card_line()
        device_rec = {**card.device_record(files["cell"]["chips"], line),
                      **device_rec}
    else:
        device_rec = {"platform": "cpu", "kind": "cpu", "count": 1,
                      "memory_peak_bytes": 0, **device_rec}
    drv.release()
    numbers = drv.check()
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = all(v <= limits[k] for k, v in numbers.items()) and \
        set(numbers) == set(limits)
    result = {"correct": correct, "attempted": win.requests, "failed": 0,
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    manifest = load_json(ROOT / "BENCHMARK.json")
    chips = cell_files(args.workload, manifest)["cell"]["chips"]

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from . import card
    print(f"card: {card.card_line()}", flush=True)
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), torch.device("cuda", 0), start,
                      manifest)
    found = forbidden_modules()
    if found:
        print(f"benchmark: JAX modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
