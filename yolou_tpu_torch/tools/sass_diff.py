"""Compare the machine code (SASS) of the kernels built from two `csrc`
directories, function by function, on a machine with the CUDA toolkit.

    python -m yolou_tpu_torch.tools.sass_diff OLD_CSRC NEW_CSRC

Each directory is compiled with `kernels/build.py`'s flags into its own
library (`_build/`, named by the hash of its sources; `tools/time_builds.py`
builds the same ones), and `cuobjdump -sass` lists each library's device
functions. A function is identical when its instructions are, after the
per-file hash in the names of anonymous namespaces and the instruction
addresses are taken out; an instruction is its text and both 64-bit words
of its encoding (the second holds the scheduling controls). Prints how
many functions are identical, differ, are new or are gone, and for each
that differs its name and instruction count in both. Two trees that differ only in code a function does not
reach leave it identical; a function that differs needs timing in turns
(`tools/time_builds.py`) before it is called unchanged.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
from pathlib import Path

from ..kernels import build

_NAMESPACE = re.compile(r"_GLOBAL__N__[0-9a-f]{8}_")
_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")
_FUNCTION = re.compile(r"\s*Function : (\S+)")
_ENCODING = re.compile(r"^\s*/\* 0x[0-9a-f]{16} \*/\s*$")


def library(csrc: Path) -> Path:
    """The kernels of `csrc`, built if this exact build is not there yet."""
    saved = build.CSRC
    try:
        build.CSRC = Path(csrc).resolve()
        return build.build()
    finally:
        build.CSRC = saved


def functions(sass: str) -> dict:
    """function name -> its instructions, from `cuobjdump -sass` output:
    each instruction line (it has an address) with the encoding line after
    it."""
    funcs, name, body = {}, None, []
    for line in sass.splitlines():
        line = _NAMESPACE.sub("_GLOBAL__N__", line)
        m = _FUNCTION.match(line)
        if m:
            if name:
                funcs[name] = body
            name, body = m.group(1), []
        elif name and _ADDRESS.search(line):
            body.append(_ADDRESS.sub("", line).strip())
        elif body and _ENCODING.match(line):
            body[-1] += " " + line.strip()
    if name:
        funcs[name] = body
    return funcs


def compare(old: dict, new: dict) -> dict:
    """{"identical": [...], "differ": [(name, old count, new count)],
    "new": [...], "gone": [...]} of two `functions` results."""
    both = [k for k in new if k in old]
    return {"identical": [k for k in both if old[k] == new[k]],
            "differ": [(k, len(old[k]), len(new[k])) for k in both
                       if old[k] != new[k]],
            "new": sorted(set(new) - set(old)),
            "gone": sorted(set(old) - set(new))}


def _sass(lib: Path) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout


def _demangle(name: str) -> str:
    if not shutil.which("c++filt"):
        return name
    return subprocess.run(["c++filt", name], capture_output=True,
                          text=True).stdout.strip()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=Path, help="the csrc directory to compare to")
    ap.add_argument("new", type=Path)
    args = ap.parse_args(argv)
    result = compare(functions(_sass(library(args.old))),
                     functions(_sass(library(args.new))))
    print(f"sass: {len(result['identical'])} functions identical, "
          f"{len(result['differ'])} differ, {len(result['new'])} new, "
          f"{len(result['gone'])} gone")
    for name, n_old, n_new in result["differ"]:
        print(f"  differs: {_demangle(name)} ({n_old} -> {n_new} "
              f"instructions)")
    for key in ("new", "gone"):
        for name in result[key]:
            print(f"  {key}: {_demangle(name)}")


if __name__ == "__main__":
    main()
