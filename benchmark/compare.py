"""The numbers that decide `correct`, each a comparison of what the timed
path produced with the plain reference.

- `channel_err`: the program's dense outputs (decoded predictions, mask
  prototypes) against the reference's, per channel the RMS of the
  difference over that channel's own spread (its standard deviation), then
  the RMS over the channels: 0 for identical outputs, about the rounding
  of the compute precision for a sound run, about 1 for unrelated ones.
- `mask_flips`: the share of mask pixels whose binary value differs from
  the reference logit's sign.
- `dets_differ`: images whose detections (boxes, scores, classes, mask
  coefficients, validity, padding) differ in any value from the reference
  NMS run on the program's own predictions: an exact comparison.
"""

from __future__ import annotations

from typing import Dict, List

import torch


def channel_errs(prog: torch.Tensor, ref: torch.Tensor, dim: int
                 ) -> torch.Tensor:
    """Per channel along `dim`: RMS(prog - ref) / std(ref)."""
    p = prog.float().movedim(dim, 0).flatten(1)
    r = ref.float().to(p.device).movedim(dim, 0).flatten(1)
    rms = (p - r).pow(2).mean(1).sqrt()
    return rms / r.std(1).clamp(min=1e-12)


def channel_err(pairs: List[tuple]) -> float:
    """RMS over every channel of `(prog, ref, dim)` pairs."""
    errs = torch.cat([channel_errs(p, r, d).cpu() for p, r, d in pairs])
    return float(errs.pow(2).mean().sqrt())


def mask_flips(pred_bin: torch.Tensor, ref_logits: torch.Tensor) -> float:
    ref = (ref_logits.float() > 0).to(pred_bin.device)
    return float((pred_bin.bool() != ref).float().mean())


DET_FIELDS = ("boxes", "conf", "cls", "extra", "valid")


def dets_differ(prog: Dict[str, torch.Tensor],
                ref: Dict[str, torch.Tensor]) -> int:
    """Images whose detections differ in any value (0.0 and -0.0 alike)."""
    bad = None
    for f in DET_FIELDS:
        same = (prog[f].cpu() == ref[f].cpu()).flatten(1).all(1)
        bad = ~same if bad is None else bad | ~same
    return int(bad.sum())
