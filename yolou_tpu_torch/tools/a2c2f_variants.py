"""Write copies of `csrc/` with one part of a whole-A2C2f kernel (the bf16
`a2c2f_wgmma_kernel` in `csrc/a2c2f_bf16.cu` or the f32 `a2c2f_f32_kernel`
in `csrc/a2c2f_f32.cu`) cut out, for the phase split: each copy computes a
wrong block, but `tools/time_builds.py` times it like any build, and the
difference to the intact kernel is what the part costs.

    python -m yolou_tpu_torch.tools.a2c2f_variants OUT_DIR [NAME ...]
    python -m yolou_tpu_torch.tools.time_builds yolou_tpu_torch/csrc \\
        OUT_DIR/no-attention/csrc ...

bf16 variants (all of them without NAME):
  no-attention  no head of the attention runs (no q or k/v copies, no
                wgmma, no softmax; u keeps what it held);
  no-stencil    the 7x7 positional term's arithmetic (its v rows still
                arrive);
  no-wgmma      the GEMMs wait for their stages and run their epilogues but
                issue no wgmma;
  no-weights    no weight stage is copied (the GEMMs run on whatever the
                ring holds; x's and the ys concat's boxes still arrive);
  no-grid-sync  no grid-wide barrier between the phases (a CTA barrier
                in its place: the phase's GEMM list is shared memory).
f32 variants (the f32 kernel's token tile is the wrapper's, `f32_tile`):
  f32-no-attention  no head of the attention runs;
  f32-no-stencil    no 7x7 positional term;
  f32-no-fma        the GEMMs stream both operands and run their epilogues
                    but do no FMA;
  f32-no-grid-sync  no grid-wide barrier between the phases.
Each is a set of exact text replacements in one source; a replacement whose
text is not found there exactly once raises, so a changed source cannot
give a variant that silently differs from its name.
"""

from __future__ import annotations

import argparse
import shutil
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BF16, F32 = "a2c2f_bf16.cu", "a2c2f_f32.cu"
GEMM = "gemm_f32.cuh"     # the f32 kernel's GEMM stream

# name -> (source, [(text, replacement), ...])
VARIANTS = {
    "no-attention": (BF16, [
        ("            const int nh = min(p.heads, (sb + 1) * CBLK / HD_) - h0;",
         "            const int nh = 0;"),
        ("            if (cw < nh)\n              attend",
         "            if (false)\n              attend"),
        ("            for (int i = 0; i < n_keys; ++i)\n"
         "              for (int j = 0; j < nbk; ++j) {",
         "            for (int i = 0; i < 0; ++i)\n"
         "              for (int j = 0; j < nbk; ++j) {"),
        ("if (cw == 0) attend_blocked(", "if (false) attend_blocked(")]),
    "no-stencil": (BF16, [("r0 < (c < ca ? rows : 0)", "r0 < 0")]),
    "no-wgmma": (BF16, [
        ("      wgmma_64x128_ss(acc, da, db, kb > 0);\n#pragma unroll\n"
         "      for (int kk = 1; kk < KBLK / 16; ++kk)\n"
         "        wgmma_64x128_ss(acc, da + 2 * kk, db + 2 * kk, 1);\n", "")]),
    "no-weights": (BF16, [
        ("(W_STAGE + (boxes ? A_BLOCK : 0)) * 2)",
         "(boxes ? A_BLOCK : 0) * 2)"),
        ("          bulk_load(b.ring + slot * W_STAGE,",
         "          if (false) bulk_load(b.ring + slot * W_STAGE,")]),
    "no-grid-sync": (BF16, [("      grid.sync();\n    }\n  }\n}",
                             "      __syncthreads();\n    }\n  }\n}")]),
    "f32-no-attention": (F32, [("for (int h = 0; h < p.heads; ++h)\n"
                                "          attend_f32",
                                "for (int h = 0; h < 0; ++h)\n"
                                "          attend_f32"),
                               ("for (int ob = 0; ob < hdp / 64; ++ob)",
                                "for (int ob = 0; ob < 0; ++ob)")]),
    "f32-no-stencil": (F32, [
        ("for (int i = tid; i < runs * C4; i += F32_THREADS) {",
         "for (int i = tid; i < 0; i += F32_THREADS) {")]),
    "f32-no-fma": (GEMM, [("    const int kmax = min(KS_F32, K - kb * KS_F32);",
                          "    const int kmax = 0;")]),
    "f32-no-grid-sync": (F32, [
        ("  fence_proxy_async_global();        // qkv is read by TMA in the "
         "next phase\n  grid.sync();", ""),
        ("      fence_proxy_async_global();\n      grid.sync();", "")]),
}


def write_variant(name: str, out: Path, csrc: Path = CSRC) -> Path:
    """Copy `csrc` to out/name/csrc with the variant's replacements applied
    to its source; returns the copy's path."""
    dst = out / name / "csrc"
    if dst.exists():
        shutil.rmtree(dst)
    shutil.copytree(csrc, dst)
    source, replacements = VARIANTS[name]
    path = dst / source
    text = path.read_text()
    for old, new in replacements:
        if text.count(old) != 1:
            raise ValueError(f"{name}: {old!r} occurs {text.count(old)} "
                             f"times in {source}, want once")
        text = text.replace(old, new)
    path.write_text(text)
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
