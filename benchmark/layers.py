"""What the per-layer readers (`metrics/<name>.py`) compute from a traced
run's context: the device's idle share, the step's share of the peak, the
kernels launched an image, and a host operation's device time and
roofline share. A reader whose cell has nothing to read returns None, and
the metric is left out of the result; a share is never given as 0 for
want of a reading.

The context (`run.py`): `trace` (`trace.Trace` over `trace.requests`
profiled requests), `images_per_request`, the untraced window's
`window_s` and `requests`, `flops_per_request` and the configuration's
`peak`. Which cells report a metric is `BENCHMARK.json`'s `workloads` for
it alone.
"""

from __future__ import annotations

from typing import Optional

from . import roofline

DTYPE_NAMES = {"float": "float32", "c10::BFloat16": "bfloat16"}


def idle_share(ctx: dict) -> Optional[float]:
    """The share of the profiled stretch in which no operation (kernel,
    copy, set) ran on the card: its busy seconds and its wall seconds are
    both the stretch's own."""
    tr = ctx["trace"]
    if tr.busy_s > tr.window_s:
        raise ValueError(f"busy {tr.busy_s} s over a {tr.window_s} s "
                         "stretch")
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def mfu(ctx: dict) -> Optional[float]:
    rate = ctx["flops_per_request"] * ctx["requests"] / ctx["window_s"]
    return 100.0 * rate / roofline.PEAK_FLOPS[ctx["peak"]]


def launches_per_image(ctx: dict) -> Optional[float]:
    tr = ctx["trace"]
    return tr.kernels / (tr.requests * ctx["images_per_request"])


def op_ms_per_call(ctx: dict, op: str) -> Optional[float]:
    """Device milliseconds a call of the host operation `op`."""
    seconds, calls = ctx["trace"].op_device(op)
    if not calls or seconds <= 0:
        return None
    return 1e3 * seconds / len(calls)


def band_attention_qkv_roofline(ctx: dict, op: str) -> Optional[float]:
    """Kernel A's share of its roofline over its calls: the sum of each
    call's least time (from its shapes: x (G, N, C), heads, dtype) over the
    device time under the calls. The peak is bf16's tensor-core rate for
    bfloat16 and float32's FMA rate for float32 (the kernels run no
    TF32)."""
    seconds, calls = ctx["trace"].op_device(op)
    if not calls or seconds <= 0:
        return None
    least = 0.0
    for shapes, dtypes, scalars in calls:
        g, n, c = shapes[0]
        heads = int(scalars[3])
        dtype = DTYPE_NAMES[dtypes[0]]
        nbytes, flops = roofline.band_attention_qkv_work(g, n, c, heads,
                                                         dtype)
        least += roofline.bound_s(nbytes, flops, dtype)
    return roofline.share(least, seconds)
