"""The yardstick's arithmetic: the card's published peaks, a call's least
time from its operations and bytes, and the operations of the timed work.

The peaks and `bound` copy `chip_smoke.py` (`HBM_BYTES_S`, `PEAK_FLOPS`,
`bound`): NVIDIA's data sheet for the H100 SXM, dense rates. The byte and
operation counts of kernel A copy `chip_smoke.py::streamed_bounds` summed
over the call (each input byte read once, each output byte written once),
its projection written as one q | k | v GEMM, as its wide form runs it.
"""

from __future__ import annotations

from typing import Callable

HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
ELEMENT_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(nbytes: float, flops: float, peak: str) -> float:
    """The least seconds the card could take: the larger of bytes over the
    memory rate and operations over the `peak` rate."""
    return max(nbytes / HBM_BYTES_S, flops / PEAK_FLOPS[peak])


def band_attention_qkv_work(g: int, n: int, c: int, heads: int, dtype: str):
    """(bytes, operations) of one kernel A call over G bands of N tokens at
    width C: x, the (C, 3C) weight and the f32 bias read, o and v written;
    the q | k | v projection's 6 G N C^2 and q.k^T and p.v's 4 G N^2 C."""
    elt = ELEMENT_BYTES[dtype]
    nbytes = elt * (g * n * c + 3 * c * c + 2 * g * n * c) + 4 * 3 * c
    flops = 6 * g * n * c * c + 4 * g * n * n * c
    return nbytes, flops


def counted_flops(fn: Callable[[], object]) -> int:
    """Operations `torch.utils.flop_counter.FlopCounterMode` counts over
    `fn()` (matrix products and convolutions, forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with counter:
        fn()
    return counter.get_total_flops()


def peak_name(dtype: str, cudnn_tf32: bool) -> str:
    """The peak the configuration's work runs against: bf16's tensor
    cores, TF32's where float32 convolutions may use them, else float32."""
    if dtype == "bfloat16":
        return "bfloat16"
    return "tf32" if cudnn_tf32 else "float32"


def share(bound: float, seconds: float) -> float:
    """A roofline share in %: the least time over the time taken."""
    return 100.0 * bound / seconds
