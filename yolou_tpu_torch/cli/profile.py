"""`python -m yolou_tpu_torch profile` — per-layer device-time profile of a
model forward: the counterpart of the JAX package's `cli/profile.py`, over
`tools/profile_layers.py` (prefix timing with `torch.profiler`'s device
time on the GPU, isotonic fit, half-table spread).

    python -m yolou_tpu_torch profile --batch 8 --imgsz 640 --out PROFILE.json
    python -m yolou_tpu_torch profile --attn      # attention variants only

Writes a per-layer table (stdout + JSON) with non-negative, isotonic-fitted
per-layer times.
"""

from ..tools.profile_layers import main as _main


def main(argv=None):
    return _main(argv)


if __name__ == "__main__":  # pragma: no cover
    main()
