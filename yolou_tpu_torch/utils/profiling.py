"""Tracing and profiling utilities.

Counterpart of `yolou_tpu/utils/profiling.py`: a `torch.profiler` trace
written to a directory, a step timer with images/s, a torchinfo-style
table of parameter counts over the module tree, and the device's memory
statistics.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch import nn


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """Record the block with `torch.profiler` (host ops, and the CUDA
    kernels where there is a GPU) and write a Chrome trace,
    `log_dir/trace.json` (default: `yolou_trace` in the temporary
    directory), viewable in Perfetto or chrome://tracing."""
    from torch.profiler import ProfilerActivity, profile
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "yolou_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Rolling step-time / throughput tracker for training loops."""

    def __init__(self, window: int = 50):
        self.window = window
        self.times: List[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    @property
    def step_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    def images_per_sec(self, batch_size: int) -> float:
        st = self.step_time
        return batch_size / st if st > 0 else float("nan")


def summarize_params(model: nn.Module, max_depth: int = 2) -> str:
    """torchinfo.summary-style table of parameter counts by subtree of the
    module tree (names joined by "/"), the JAX package's table and order:
    subtrees deeper than `max_depth` are summed, siblings sorted by (name
    length, name). It counts the learnable parameters, flax's `params`:
    ultralytics' fixed DFL projection, a parameter that requires no grad,
    is left out."""
    tree: Dict = {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        *path, leaf = name.split(".")
        node = tree
        for seg in path:
            node = node.setdefault(seg, {})
        node[leaf] = p.numel()

    def count(t) -> int:
        return sum(count(v) for v in t.values()) if isinstance(t, dict) else t

    rows = []

    def walk(t, path, depth):
        if depth >= max_depth or not isinstance(t, dict):
            rows.append(("/".join(path), count(t)))
            return
        for k in sorted(t.keys(), key=lambda s: (len(s), s)):
            walk(t[k], path + [k], depth + 1)

    walk(tree, [], 0)
    total = count(tree)
    width = max(len(r[0]) for r in rows) if rows else 10
    lines = [f"{'module':<{width}}  params"]
    lines += [f"{name:<{width}}  {n:,}" for name, n in rows]
    lines.append(f"{'TOTAL':<{width}}  {total:,}")
    return "\n".join(lines)


def device_memory_stats() -> Dict[str, float]:
    """The CUDA device's memory statistics in GB (`torch.cuda.memory_stats`,
    its byte counts: current, peak, allocated and freed, by pool), as the
    JAX package reports its device's; `{}` where there is no CUDA device."""
    if not torch.cuda.is_available():
        return {}
    return {k: v / 1e9 for k, v in torch.cuda.memory_stats().items()
            if "bytes" in k}
