"""Build and load the hand-written CUDA kernels (`../csrc/*.cu`).

`nvcc` compiles every source in `csrc/` into one shared library with a plain
C interface, for `sm_90a` (Hopper), on first use; `ctypes` loads it. The
library lands in `_build/` next to this package (listed in .gitignore) under
a name that hashes the sources and flags, so an edited source is rebuilt and
a finished build is reused. Nothing here runs at import time: the CPU tests
import every module on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libyolou_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this exact build is not there yet."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, *map(str, _sources())]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if verbose:
            print(res.stdout + res.stderr)
        os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call in this process)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.yolou_band_attention_qkv.argtypes = [vp, vp, vp, vp, vp,
                                                 ci, ci, ci, ci, ci, vp]
        lib.yolou_band_attention_qkv.restype = ci
        lib.yolou_band_attention.argtypes = [vp, vp, vp, vp,
                                             ci, ci, ci, ci, ci, vp]
        lib.yolou_band_attention.restype = ci
        lib.yolou_greedy_nms.argtypes = [vp, vp, vp, vp, ci, ci, cf, vp]
        lib.yolou_greedy_nms.restype = ci
        lib.yolou_error_string.argtypes = [ci]
        lib.yolou_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its launch status)."""
    if code != 0:
        msg = lib.yolou_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
