"""Write copies of `csrc/` with one part of a whole-A2C2f kernel (the bf16
`a2c2f_mma_kernel` or the f32 `a2c2f_f32_kernel` in `csrc/a2c2f.cu`) cut out
or changed, for the phase split: each copy computes a wrong block, but
`tools/time_builds.py` times it like any build, and the difference to the
intact kernel is what the part costs.

    python -m yolou_tpu_torch.tools.a2c2f_variants OUT_DIR [NAME ...]
    python -m yolou_tpu_torch.tools.time_builds yolou_tpu_torch/csrc \\
        OUT_DIR/no-attention/csrc ...

Variants (all of them without NAME):
  no-attention  no head of the attention runs (no k/v staging, no
                attend, no merge);
  no-kv-copy, no-q-load, no-attend, no-merge  the attention's parts: no
                k/v copies, no q fragments read, no online softmax, no merge
                of the partial states;
  no-stencil    no 7x7 positional term;
  no-weights    no weight slab is copied into the ring (the GEMMs run on
                whatever the ring holds);
  no-mma        the GEMMs copy their weights and run their epilogues but do
                no ldmatrix and no mma;
  no-grid-sync  no grid-wide barrier between the phases;
  run1, run4    the stencil's thread takes 1 or 4 tokens (2 in the source);
  slab32        weight slabs of 32 rows (64 in the source);
  tile16, tile32, tile64  one token tile at every shape (the launch takes
                the one with the fewest waves).
f32 variants (the f32 kernel's token tile is the wrapper's, `f32_tile`):
  f32-no-attention  no head of the attention runs;
  f32-no-stencil    no 7x7 positional term;
  f32-no-fma        the GEMMs stream both operands and run their epilogues
                    but do no FMA;
  f32-no-grid-sync  no grid-wide barrier between the phases.
Each is a set of exact text replacements in one part of a2c2f.cu: the bf16
part (from the line MARK on) or the f32 part (from F32_MARK to MARK); a
replacement whose text is not found there exactly once raises, so a changed
source cannot give a variant that silently differs from its name.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
MARK = ("// ------------------------------------------------- "
        "bf16 on tensor cores")
F32_MARK = ("// ------------------------------------------------- "
            "f32 on register tiles")

VARIANTS = {
    "no-attention": [("for (int h = 0; h < p.heads; ++h) {",
                      "for (int h = 0; h < 0; ++h) {"),
                     ("      else stage_kv(0);", "      else;")],
    "no-kv-copy": [("        for (int i = tid; i < Np * CH; i += blockDim.x) {",
                    "        for (int i = tid; i < 0; i += blockDim.x) {")],
    "no-q-load": [("        if (r0 < rows) {\n          const uint32_t* qg",
                   "        if (r0 < 0) {\n          const uint32_t* qg")],
    "no-attend": [("            if (kb < ke)\n              attend_keys_mma",
                   "            if (kb < 0)\n              attend_keys_mma")],
    "no-merge": [("        for (int i = tid; i < TILE * HD_; i += blockDim.x) {",
                  "        for (int i = tid; i < 0; i += blockDim.x) {")],
    "no-stencil": [("for (int i = tid; i < runs * C8; i += blockDim.x) {",
                    "for (int i = tid; i < 0; i += blockDim.x) {")],
    "no-weights": [("for (int idx = threadIdx.x; idx < KS * (NP / 8); "
                    "idx += blockDim.x) {",
                    "for (int idx = threadIdx.x; idx < 0; "
                    "idx += blockDim.x) {")],
    "no-mma": [("      if (k < K16) {                  // warp-uniform",
                "      if (k < 0) {                    // warp-uniform")],
    "no-grid-sync": [("  grid.sync();\n\n  // ---- one phase per ABlock",
                      "\n\n  // ---- one phase per ABlock"),
                     ("    if (!last) grid.sync();\n", "")],
    "run1": [("constexpr int RUN = 2; ", "constexpr int RUN = 1; ")],
    "run4": [("constexpr int RUN = 2; ", "constexpr int RUN = 4; ")],
    "slab32": [("constexpr int KS = 64; ", "constexpr int KS = 32; ")],
}
for _tile in (16, 32, 64):       # one token tile at every shape
    VARIANTS[f"tile{_tile}"] = [
        (f"  consider<{t}>(p, info, plan);\n", "")
        for t in (16, 32, 64) if t != _tile]
F32_VARIANTS = {
    "f32-no-attention": [("for (int h = 0; h < p.heads; ++h)\n"
                          "        attend_f32",
                          "for (int h = 0; h < 0; ++h)\n"
                          "        attend_f32")],
    "f32-no-stencil": [("for (int i = tid; i < runs * C4; i += F32_THREADS) {",
                        "for (int i = tid; i < 0; i += F32_THREADS) {")],
    "f32-no-fma": [("    const int kmax = min(KS_F32, K - kb * KS_F32);",
                    "    const int kmax = 0;")],
    "f32-no-grid-sync": [("  fence_proxy_async_global();        // qkv is "
                          "read by TMA in the next phase\n  grid.sync();",
                          ""),
                         ("      fence_proxy_async_global();\n"
                          "      grid.sync();", "")],
}
VARIANTS.update(F32_VARIANTS)


def write_variant(name: str, out: Path, csrc: Path = CSRC) -> Path:
    """Copy `csrc` to out/name/csrc with the variant's replacements applied
    to a2c2f.cu; returns the copy's path."""
    dst = out / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(csrc, dst)
    src = dst / "a2c2f.cu"
    source = src.read_text()
    head, mark, text = source.partition(MARK)
    f32_head, f32_mark, f32_text = head.partition(F32_MARK)
    if not (mark and f32_mark):
        raise ValueError(f"a2c2f.cu lacks {MARK!r} or {F32_MARK!r}")
    part = "f32" if name in F32_VARIANTS else "bf16"
    body = f32_text if part == "f32" else text
    for old, new in VARIANTS[name]:
        if body.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {body.count(old)} "
                             f"times in a2c2f.cu's {part} part, want once")
        body = body.replace(old, new)
    if part == "f32":
        src.write_text(f32_head + f32_mark + body + mark + text)
    else:
        src.write_text(head + mark + body)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", type=Path, help="directory for the copies")
    ap.add_argument("names", nargs="*", help=f"of {sorted(VARIANTS)}")
    args = ap.parse_args(argv)
    for name in args.names or sorted(VARIANTS):
        print(write_variant(name, args.out))


if __name__ == "__main__":
    main()
