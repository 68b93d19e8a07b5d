"""Build and load the hand-written CUDA kernels (`../csrc/*.cu`).

`nvcc` compiles every source in `csrc/` for `sm_90a` (Hopper) on first use,
one process per source and all at once, and links the objects into one
shared library with a plain C interface; `ctypes` loads it. The library is
kept in `buildcache.py`'s cache, keyed by the sources, headers and flags.
Nothing here runs at import time: the CPU tests import every module on
machines without nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

from .. import buildcache

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    return buildcache.library_path(
        "libyolou_kernels", NVCC_FLAGS,
        _sources() + sorted(CSRC.glob("*.cuh")))


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this exact build is not there yet: one nvcc per
    source, all started together, then one link. With `verbose`, prints
    ptxas' register and spill report for each kernel. Raises with the
    compiler's output if nvcc fails."""
    logs = []

    def compile(tmp: Path) -> Path:
        nvcc, sources = _nvcc(), _sources()
        flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
        objects = [str(tmp / f"{src.stem}.o") for src in sources]
        cmds = [[nvcc, *flags, "-c", "-o", obj, str(src)]
                for obj, src in zip(objects, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs.extend(proc.communicate()[0] for proc in procs)  # waits for each
        for cmd, proc, text in zip(cmds, procs, logs):
            buildcache.check("nvcc", cmd, proc.returncode, text)
        lib = tmp / "lib.so"
        buildcache.run("nvcc", [nvcc, "-shared", "-o", str(lib), *objects])
        return lib

    out = buildcache.build_once(library_path(), compile)
    if verbose and logs:
        print("".join(logs))
    return out


def bind(lib: ctypes.CDLL, missing_ok: bool = False) -> ctypes.CDLL:
    """Give each C entry point of `lib` its argument and result types;
    `missing_ok` skips the entries a library built from an older source
    tree lacks (`tools/time_builds.py` times such trees)."""
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    entries = {
        "yolou_band_attention_qkv_stream": [vp] * 6 + [ci] * 6 + [cf, vp],
        "yolou_band_attention_qkv_wide": [vp] * 7 + [ci] * 6 + [cf, vp],
        "yolou_band_attention_qkv_short": [vp] * 5 + [ci] * 6 + [cf, vp],
        "yolou_band_attention_stream": [vp] * 4 + [ci] * 6 + [cf, vp],
        "yolou_band_attention_short": [vp] * 4 + [ci] * 6 + [cf, vp],
        "yolou_band_attention_stream_padded": [vp] * 4 + [ci] * 6 + [cf, vp],
        "yolou_band_attention_short_padded": [vp] * 4 + [ci] * 6 + [cf, vp],
        "yolou_tma_head_box": [vp, vp] + [ci] * 9 + [vp],
        "yolou_greedy_nms": [vp, vp, vp, ci, ci, cf, vp],
        "yolou_a2c2f": [vp, ctypes.POINTER(vp), ci, vp, vp, vp, *[ci] * 11,
                        vp, vp, ci, cf, ci, vp],
    }
    for name, argtypes in entries.items():
        if missing_ok and not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ci
    lib.yolou_error_string.argtypes = [ci]
    lib.yolou_error_string.restype = ctypes.c_char_p
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library, built from `csrc/` on the first call in
    this process."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its launch status)."""
    if code != 0:
        msg = lib.yolou_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
