"""Build and load the PNG decoder (`yolou_io.cc`) through ctypes.

`g++ -O3 -fPIC -shared` compiles the source on first use into
`buildcache.py`'s cache, keyed by the source and the flags, as the CUDA
kernels are. A failed build raises with the compiler's output; nothing
falls back. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from .. import buildcache

SOURCE = Path(__file__).resolve().parent / "yolou_io.cc"
BUILD_DIR = buildcache.BUILD_DIR
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lz",)
ABI_VERSION = 1
ERRORS = {-1: "cannot open", -2: "cannot read", -3: "not a PNG (signature)",
          -4: "truncated chunk", -5: "bad IHDR", -6: "unsupported kind",
          -7: "IDAT does not inflate to the image's size",
          -8: "unknown scanline filter", -9: "output buffer size"}
COLOR_TYPES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
               6: "RGBA"}
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    return buildcache.library_path("libyolou_io", CXX_FLAGS + LIBS,
                                   [SOURCE], BUILD_DIR)


def build() -> Path:
    """Compile the decoder if this exact build is not there yet. Raises with
    the compiler's output if g++ fails or is absent."""
    def compile(tmp: Path) -> Path:
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError("g++ not found: the PNG decoder cannot be "
                               "built")
        lib = tmp / "lib.so"
        buildcache.run("g++", [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(lib),
                               *LIBS])
        return lib

    return buildcache.build_once(library_path(), compile)


def load() -> ctypes.CDLL:
    """The loaded decoder, built on the first call in this process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        if lib.yio_version() != ABI_VERSION:
            raise RuntimeError(f"{library_path()}: ABI version "
                               f"{lib.yio_version()}, want {ABI_VERSION}")
        lib.yio_png_header.argtypes = [ctypes.c_char_p,
                                       ctypes.POINTER(ctypes.c_int)]
        lib.yio_png_header.restype = ctypes.c_int
        lib.yio_decode_png_file.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                            ctypes.c_size_t]
        lib.yio_decode_png_file.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(code: int, path: str) -> None:
    if code != 0:
        raise IOError(f"{path}: {ERRORS.get(code, f'error {code}')}")


def png_header(path: str) -> Tuple[int, int, int, int, int]:
    """(width, height, bit depth, colour type, interlace method) of a PNG."""
    info = (ctypes.c_int * 5)()
    _check(load().yio_png_header(os.fsencode(path), info), path)
    return tuple(info)


def _kind(depth: int, ctype: int, interlace: int) -> Optional[str]:
    if depth == 8 and interlace == 0 and ctype in CHANNELS:
        return None
    return (f"colour type {ctype} = {COLOR_TYPES.get(ctype, 'undefined')}, "
            f"bit depth {depth}{', interlaced' if interlace else ''}")


def unsupported_kind(path: str) -> Optional[str]:
    """None where `decode_png` reads the PNG at `path`, else its kind
    (colour type, bit depth, interlacing) in words."""
    return _kind(*png_header(path)[2:])


def decode_png(path: str) -> np.ndarray:
    """(H, W, C) uint8 pixels of an 8-bit, non-interlaced gray (C = 1),
    gray+alpha (2), RGB (3) or RGBA (4) PNG, colour in cv2's order (B, G,
    R(, A)). Any other kind raises an error that names the file, its colour
    type and its bit depth."""
    w, h, depth, ctype, interlace = png_header(path)
    kind = _kind(depth, ctype, interlace)
    if kind is not None:
        raise IOError(
            f"{path}: unsupported PNG ({kind}); this decoder reads "
            f"8-bit gray, gray+alpha, RGB and RGBA, not interlaced")
    out = np.empty((h, w, CHANNELS[ctype]), np.uint8)
    _check(load().yio_decode_png_file(os.fsencode(path), out.ctypes.data,
                                      out.nbytes), path)
    return out
