"""Traffic drivers: the general generators that traffic files name.

A traffic file (`benchmark/traffic/<name>.json`) names its driver
(`"driver"`) and holds its parameters. A driver module defines `Driver`,
built as `Driver(config, traffic, seed, device)`: it makes the weights and
inputs from the seed, builds the program's entry point, and offers
- `images_per_request`;
- `warm()`: every shape the window uses, before it;
- `window(first, seconds)`: the measured window, its requests numbered
  from `first`; returns a `Window`;
- `statistics(window)`: every end-to-end statistic the driver computes
  over a window (name -> value); a traffic file's `end_to_end` maps each of
  its cell's end-to-end metrics to one of them;
- `request(i)`: request (or training step) `i`; an inference request
  returns with its answers on the host;
- `sync()`: wait for the card;
- `flops_per_request()`: operations of one request, counted over the
  plain reference on the meta device;
- `check()`: after the window, the program freed, each compared number
  against the reference (name -> value);
- `control()`: the same numbers with the reference in the precision
  below the configuration's in the program's place.

`ClosedLoop` gives `window` and `statistics` for one client sending each
request when the last has returned; a driver of other arrivals (an open
loop at a fixed rate, say) is a module of its own with its own `window`
and `statistics`.
"""

import statistics as stats
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class Window:
    """What a window did: its requests (`next` is the number of the first
    request after it), the images they carried, its wall seconds from the
    first request's start to the card synchronised after the last, and
    each request's latency in seconds."""
    requests: int
    images: int
    wall_s: float
    next: int
    latencies: List[float] = field(default_factory=list)


class ClosedLoop:
    """Requests back to back from one client, for `seconds` of wall
    time."""

    images_per_request: int

    def window(self, first: int, seconds: float) -> Window:
        latencies: List[float] = []
        i = first
        start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            self.request(i)
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
            i += 1
            if t1 - start >= seconds:
                break
        self.sync()
        wall = time.perf_counter() - start
        return Window(len(latencies), len(latencies) * self.images_per_request,
                      wall, i, latencies)

    def statistics(self, w: Window) -> Dict[str, float]:
        """Images completed a second over the whole window, and the 95th
        percentile of every request's latency in ms (a window of one
        request: its latency)."""
        lat = w.latencies
        p95 = stats.quantiles(lat, n=20)[18] if len(lat) > 1 else lat[0]
        return {"images_per_s": w.images / w.wall_s,
                "latency_p95_ms": 1e3 * p95}

    def sync(self) -> None:
        """Nothing to wait for: a request returns with its answers."""
