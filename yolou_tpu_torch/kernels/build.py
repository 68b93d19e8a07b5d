"""Build and load the hand-written CUDA kernels (`../csrc/*.cu`).

`nvcc` compiles every source in `csrc/` for `sm_90a` (Hopper) on first use,
one process per source and all at once, and links the objects into one
shared library with a plain C interface; `ctypes` loads it. The library
lands in `_build/` next to this package (listed in .gitignore) under a name
that hashes the sources, headers and flags, so an edited source is rebuilt
and a finished build is reused. Nothing here runs at import time: the CPU tests
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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libyolou_kernels_{h.hexdigest()[:16]}.so"


def _check_nvcc(cmd, returncode: int, text: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{text}")


def build(verbose: bool = False) -> Path:
    """Compile the kernels if this exact build is not there yet: one nvcc per
    source, all started together, then one link. With `verbose`, prints
    ptxas' register and spill report for each kernel. Raises with the
    compiler's output if nvcc fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, sources = _nvcc(), _sources()
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objects = [os.path.join(tmp, f"{src.stem}.o") for src in sources]
        cmds = [[nvcc, *flags, "-c", "-o", obj, str(src)]
                for obj, src in zip(objects, sources)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        logs = [proc.communicate()[0] for proc in procs]   # waits for each
        for cmd, proc, text in zip(cmds, procs, logs):
            _check_nvcc(cmd, proc.returncode, text)
        lib = os.path.join(tmp, "lib.so")
        link = [nvcc, "-shared", "-o", lib, *objects]
        res = subprocess.run(link, capture_output=True, text=True)
        _check_nvcc(link, res.returncode, res.stdout + res.stderr)
        os.replace(lib, out)   # atomic: a concurrent build sees all or none
    if verbose:
        print("".join(logs))
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built from `csrc/` on the first call in
    this process."""
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
        lib.yolou_greedy_nms.argtypes = [vp, vp, vp, ci, ci, cf, vp]
        lib.yolou_greedy_nms.restype = ci
        lib.yolou_a2c2f.argtypes = [vp, ctypes.POINTER(vp), ci, vp, vp, vp,
                                    *([ci] * 10), vp]
        lib.yolou_a2c2f.restype = ci
        lib.yolou_error_string.argtypes = [ci]
        lib.yolou_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error (its launch status)."""
    if code != 0:
        msg = lib.yolou_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
