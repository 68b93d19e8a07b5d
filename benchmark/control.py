"""Readings that set a cell's limits (`benchmark/cells/<cell>.json`), on
the card at the cell's own size, many seeds in one process:

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        [--program] [--control] [--fault <name>]

`--program`: the program's numbers, each seed through the timed path as a
run drives it (set-up and its warm-up or first training steps, the `kept`
requests of an inference cell, the program freed, the check against the
reference). `--control`: the same numbers when the
plain reference, computed in the precision below the configuration's
(`"control"` in its file: bfloat16 below float32 with TF32 convolutions,
float8 e4m3 operands below bfloat16), answers in the program's place. A
limit lies between the largest program reading and the smallest control
reading. `--fault`: the program's numbers with a fault of `faults.py`
planted (a training cell's limits are also held against these). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import time

import torch

from . import faults, run


def readings(workload: str, seed: int, program: bool, control: bool,
             device: torch.device, overrides=None, fault: str = "") -> dict:
    manifest = run.load_json(run.ROOT / "BENCHMARK.json")
    files = run.cell_files(workload, manifest)
    overrides = overrides or {}
    cfg = {**files["config"], **overrides.get("config", {})}
    traffic = {**files["traffic"], **overrides.get("traffic", {})}
    torch.backends.cudnn.allow_tf32 = cfg["cudnn_tf32"]
    torch.backends.cuda.matmul.allow_tf32 = cfg["matmul_tf32"]
    mod = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    out = {"seed": seed, **({"fault": fault} if fault else {})}
    t0 = time.perf_counter()
    with (faults.planted(fault, traffic["driver"]) if fault
          else contextlib.nullcontext()):
        drv = mod.Driver(cfg, traffic, seed, device)
        if program:
            drv.warm()
            for i in range(traffic.get("kept", 0)):
                drv.request(traffic["warmup_requests"] + i)
            drv.sync()
    drv.release()
    if program:
        out["program"] = drv.check()
    if control:
        out["control"] = drv.control()
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="")
    args = ap.parse_args(argv)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.program,
                                  args.control, device, fault=args.fault)),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
