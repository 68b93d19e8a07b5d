"""The traced stretch of a run and its reduction to the per-layer inputs.

`profile_requests` records a few requests with `torch.profiler` (CPU ops
with their input shapes, and the card's kernels, copies and sets through
CUPTI), after one request it records and discards so that the profiler's
own start-up is not in the stretch. Nothing is written to disk: the raw
events are read in memory (`kineto_results.events()`, the sum
`yolou_tpu_torch/tools/profile_layers.py::trace_device_us` takes, copied
here).

`Trace` reduces them: the stretch's window (the first request's span to
the last one's end; each request ends with the card synchronised), the
seconds in which the card ran an operation (the union of its events'
intervals), the kernels launched, the device seconds and calls under a
named host operation (a device event belongs to the host operation whose
launch it records, `linked_correlation_id`, and so to every operation
around that one), and the breakdown: the device operations that took most
time, and the card's idle time by the innermost host operation running at
the middle of each gap.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

SPAN = "bench.request"
TOP = 10


def profile_requests(step: Callable[[int], None], first: int, count: int):
    """Run `step(first)` .. `step(first + count)`; the last `count` are
    traced. Returns the raw kineto events."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    out = {}

    def ready(prof):
        out["events"] = list(prof.profiler.kineto_results.events())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=count, repeat=1),
                 on_trace_ready=ready, record_shapes=True) as prof:
        for i in range(count + 1):
            with record_function(SPAN):
                step(first + i)
            prof.step()
    return out.get("events", [])


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], b))
        else:
            merged.append((a, b))
    return merged


class Trace:
    """The reduced stretch (times in seconds)."""

    def __init__(self, events, requests: int):
        cuda = torch.autograd.DeviceType.CUDA
        self.requests = requests
        self.cpu, self.dev = [], []
        for e in events:
            if e.device_type() == cuda:
                if not e.is_user_annotation() and e.name() != SPAN:
                    self.dev.append((e.start_ns(), e.end_ns(), e.name(),
                                     e.linked_correlation_id()))
            else:
                self.cpu.append(e)
        spans = [(e.start_ns(), e.end_ns()) for e in self.cpu
                 if e.name() == SPAN]
        if not spans or not self.dev:
            raise RuntimeError("the profiler recorded no request span or no "
                               "device operation")
        self.t0 = min(a for a, _ in spans)
        self.t1 = max(max(b for _, b in spans),
                      max(b for _, b, _, _ in self.dev))
        self.dev = [d for d in self.dev if d[1] > self.t0 and d[0] < self.t1]
        self.busy = _merge([(max(a, self.t0), min(b, self.t1))
                            for a, b, _, _ in self.dev])
        self.window_s = (self.t1 - self.t0) / 1e9
        self.busy_s = sum(b - a for a, b in self.busy) / 1e9
        self.kernels = sum(1 for d in self.dev
                           if not d[2].startswith(("Memcpy", "Memset")))

    def op_device(self, name: str):
        """(device seconds, calls) under the host operation `name`; a call
        is (input shapes, input dtypes, concrete scalar inputs)."""
        calls = sorted(((e.start_ns(), e.end_ns(),
                         (e.shapes(), e.dtypes(), e.concrete_inputs()))
                        for e in self.cpu if e.name() == name),
                       key=lambda c: c[0])
        if not calls:
            return 0.0, []
        launch = {e.correlation_id(): e.start_ns() for e in self.cpu
                  if e.linked_correlation_id() == 0}
        starts = [c[0] for c in calls]
        ns = 0
        for a, b, _, corr in self.dev:
            t = launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= calls[i][1]:
                ns += b - a
        return ns / 1e9, [c[2] for c in calls]

    def breakdown(self) -> Dict[str, list]:
        by_name: Dict[str, int] = defaultdict(int)
        for a, b, name, _ in self.dev:
            by_name[name[:200]] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        host = sorted((e.start_ns(), e.end_ns(), e.name()) for e in self.cpu
                      if e.end_ns() > e.start_ns())
        starts = [h[0] for h in host]
        parent, stack = [], []
        for a, b, _ in host:
            while stack and host[stack[-1]][1] < a:
                stack.pop()
            parent.append(stack[-1] if stack else -1)
            stack.append(len(parent) - 1)
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        idle: Dict[str, int] = defaultdict(int)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and host[i][1] < mid:
                i = parent[i]
            idle[host[i][2][:200] if i >= 0 else "(no host operation)"] += \
                b - a
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gaps]}
