"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper checks its inputs, then: on a CPU tensor runs the kernel's plain
PyTorch version; on a CUDA tensor launches the kernel (building it on first
use) or raises. It never falls back from a CUDA tensor to the plain version.
Each wrapper counts its kernel launches in a `launches` attribute; the
differentiable ones also count the calls of their backward (plain tensor
code, no kernel) in `backward_calls`.
"""

from __future__ import annotations

from typing import Dict

from .a2c2f import a2c2f_fused
from .attention import (area_attention, area_attention_fused,
                        area_attention_qkv_fused)
from .nms import suppress_greedy

_WRAPPERS = {"band_attention": area_attention_qkv_fused,
             "greedy_nms": suppress_greedy,
             "band_attention_train": area_attention_fused,
             "band_attention_single": area_attention,
             "a2c2f": a2c2f_fused}


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def backward_counts() -> Dict[str, int]:
    """Differentiable kernel name -> backward calls since the last reset."""
    return {name: fn.backward_calls for name, fn in _WRAPPERS.items()
            if hasattr(fn, "backward_calls")}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "backward_calls"):
            fn.backward_calls = 0
