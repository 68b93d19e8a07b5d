"""The card a run uses, as `nvidia-smi` and torch report it.

`card_line` copies `yolou_tpu_torch/tools/profile_layers.py::
card_name_and_power_limit` (the query, the row of the current device) and
adds the clocks.
"""

from __future__ import annotations

import subprocess
from typing import Dict

import torch

QUERY = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem"


def card_line() -> str:
    """`nvidia-smi`'s name, power limit and clocks of the current device."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={QUERY}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[torch.cuda.current_device()]


def power_limit_w(line: str) -> float:
    """The power limit in watts from `card_line`'s second field."""
    return float(line.split(",")[1].strip().split()[0])


def device_record(chips: int, line: str) -> Dict[str, object]:
    """The result's `device` object (without the traced fields)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips)),
            "power_limit_w": power_limit_w(line)}
