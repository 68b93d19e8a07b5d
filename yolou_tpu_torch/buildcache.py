"""The build cache of the package's native code: the CUDA kernels
(`kernels/build.py`, nvcc) and the PNG decoder (`native/loader.py`, g++).

A shared library is compiled on first use into `_build/` next to this
package (listed in .gitignore) under a name that hashes the compiler flags
and the files it is built from, so an edited source is rebuilt and a
finished build is reused. It is compiled in a temporary directory beside
its final name and published with one `os.replace`, so a concurrent build
sees all of it or none. A compiler that fails raises with its output;
nothing falls back. Nothing here runs at import time.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Callable, Iterable, Sequence

BUILD_DIR = Path(__file__).resolve().parent / "_build"


def library_path(stem: str, flags: Sequence[str], files: Iterable[Path],
                 build_dir: Path = BUILD_DIR) -> Path:
    """`build_dir/<stem>_<hash>.so`, the hash over `flags` and each file's
    name and bytes."""
    h = hashlib.sha256(" ".join(flags).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return build_dir / f"{stem}_{h.hexdigest()[:16]}.so"


def check(compiler: str, cmd: Sequence[str], returncode: int,
          output: str) -> None:
    """Raise with the command and the compiler's output if it failed."""
    if returncode != 0:
        raise RuntimeError(f"{compiler} failed ({returncode}):\n"
                           f"{' '.join(cmd)}\n{output}")


def run(compiler: str, cmd: Sequence[str]) -> None:
    """Run one compiler command; raise with its output if it fails."""
    res = subprocess.run(cmd, capture_output=True, text=True)
    check(compiler, cmd, res.returncode, res.stdout + res.stderr)


def build_once(out: Path, compile: Callable[[Path], Path]) -> Path:
    """`out`, unless it exists already made by `compile(tmp)`, which builds
    the library in the temporary directory `tmp` and returns its path."""
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        os.replace(compile(Path(tmp)), out)
    return out
