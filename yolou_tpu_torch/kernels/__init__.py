"""Hand-written CUDA kernels for Hopper and their wrappers.

Each wrapper checks its inputs, then calls its kernel's `torch.library`
operator (`yolou::band_attention_qkv`, `band_attention`,
`band_attention_single`, `greedy_nms`, `a2c2f`; importing this package
registers them, building nothing). The operator's real version, on a CPU
tensor, runs the kernel's plain PyTorch version; on a CUDA tensor it
launches the kernel (building it on first use) or raises. It never falls
back from a CUDA tensor to the plain version. Its fake version gives only
the outputs' shapes and types, so `torch.export` and other graph captures
record each launch as one node. Each wrapper counts its kernel launches in
a `launches` attribute, in the real version only, one a call; kernel A,
whose streamed path and wide form start two device kernels a call, also
counts those in `device_launches`; kernels A and C count their launches by
path and type in `path_launches`. The differentiable ones also count the calls of their
backward (plain tensor code, no kernel) in `backward_calls`.
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


def device_counts() -> Dict[str, int]:
    """Kernel name -> device kernels started since the last reset (its
    launches, but for kernel A's streamed path and wide form: two a
    launch)."""
    return {name: getattr(fn, "device_launches", fn.launches)
            for name, fn in _WRAPPERS.items()}


def path_counts(name: str = "band_attention") -> Dict[str, int]:
    """The launches of band attention kernel `name` (kernel A by default;
    "band_attention_train", "band_attention_single": kernel C) since the
    last reset by path and type ("short bf16", "streamed f32", "wide bf16"
    (kernel A's wide form), "blocked bf16" (heads wider than 64), ...;
    `attention.attention_plan`'s paths)."""
    return dict(_WRAPPERS[name].path_launches)


def backward_counts() -> Dict[str, int]:
    """Differentiable kernel name -> backward calls since the last reset."""
    return {name: fn.backward_calls for name, fn in _WRAPPERS.items()
            if hasattr(fn, "backward_calls")}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0
        if hasattr(fn, "device_launches"):
            fn.device_launches = 0
        if hasattr(fn, "path_launches"):
            fn.path_launches = {}
        if hasattr(fn, "backward_calls"):
            fn.backward_calls = 0
