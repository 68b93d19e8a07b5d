"""Segmentation metrics on the masks' device: Dice, pixel precision / recall
counts, HD95.

Counterpart of `yolou_tpu/metrics/seg.py` (MONAI semantics: Dice with
`ignore_empty=False`, the symmetric 95th-percentile Hausdorff distance,
NaN-aware aggregation). HD95 uses an exact squared Euclidean distance
transform built from two 1D min-plus passes (separable EDT), boolean surface
masks and a masked sort with numpy's linear-interpolation percentile. Every
function is plain tensor code over a leading batch axis: fixed shapes, no
data-dependent control flow, no host transfer.
"""

from __future__ import annotations

from typing import Tuple

import torch

_INF = 1e12


def dice_binary(pred: torch.Tensor, target: torch.Tensor,
                ignore_empty: bool = False) -> torch.Tensor:
    """Per-sample binary Dice. pred / target (B, ...) in {0, 1}.

    ignore_empty=False: empty target and empty pred -> 1.0; empty target,
    non-empty pred -> 0.0. ignore_empty=True: empty target -> NaN."""
    p = pred.float().flatten(1)
    g = target.float().flatten(1)
    inter = (p * g).sum(1)
    denom = p.sum(1) + g.sum(1)
    dice = torch.where(denom > 0, 2.0 * inter / denom.clamp(min=1e-12),
                       torch.ones_like(denom))
    if ignore_empty:
        dice = torch.where(g.sum(1) > 0, dice,
                           torch.full_like(dice, float("nan")))
    return dice


def precision_recall_counts(pred: torch.Tensor, target: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Pixel TP / FP / FN sums (scalars) over the whole batch."""
    p = pred.float()
    g = target.float()
    return (p * g).sum(), (p * (1 - g)).sum(), ((1 - p) * g).sum()


def _edt_sq_2d(mask: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT: distance from every pixel to the nearest True
    pixel. Separable min-plus, column pass then row pass. (..., H, W) bool ->
    (..., H, W) f32; about _INF everywhere where a mask is empty."""
    h, w = mask.shape[-2:]
    g = torch.where(mask, 0.0, _INF).to(torch.float32)
    y = torch.arange(h, dtype=torch.float32, device=mask.device)
    dy2 = (y[:, None] - y[None, :]) ** 2                    # (H, H')
    d1 = (g[..., None, :, :] + dy2[:, :, None]).amin(-2)    # (..., H, W)
    x = torch.arange(w, dtype=torch.float32, device=mask.device)
    dx2 = (x[:, None] - x[None, :]) ** 2                    # (W, W')
    return (d1[..., None, :] + dx2).amin(-1)


def _surface(mask: torch.Tensor) -> torch.Tensor:
    """Boundary pixels of (..., H, W) masks: the mask minus its erosion with
    the 4-connected cross (zero padding)."""
    m = mask.bool()
    pad = torch.nn.functional.pad(m, (1, 1, 1, 1), value=False)
    er = (pad[..., 1:-1, 1:-1] & pad[..., :-2, 1:-1] & pad[..., 2:, 1:-1]
          & pad[..., 1:-1, :-2] & pad[..., 1:-1, 2:])
    return m & ~er


def _masked_percentile(values: torch.Tensor, mask: torch.Tensor,
                       q: float) -> torch.Tensor:
    """Linear-interpolated percentile of values[mask] over the last axis
    (numpy semantics); NaN where the mask is empty. Fixed shape: sorts with
    +inf in the masked-out places and indexes by the count."""
    v = torch.where(mask, values, float("inf")).sort(-1).values
    last = v.shape[-1] - 1
    n = mask.sum(-1).to(torch.float32)
    pos = (q / 100.0) * (n - 1.0)
    lo = pos.floor().clamp(0, last).long()
    hi = (lo + 1).clamp(0, last)
    frac = pos - lo.to(torch.float32)
    v_lo = v.gather(-1, lo[..., None])[..., 0]
    hi_val = torch.where(n > lo + 1, v.gather(-1, hi[..., None])[..., 0], v_lo)
    out = v_lo * (1 - frac) + hi_val * frac
    return torch.where(n > 0, out, torch.full_like(out, float("nan")))


def hd95_batch(pred: torch.Tensor, target: torch.Tensor,
               percentile: float = 95.0) -> torch.Tensor:
    """(B, H, W) binary masks -> (B,) symmetric Hausdorff percentile,
    max(perc(d(surface_pred -> surface_gt)), perc(d(surface_gt ->
    surface_pred))); NaN where either surface is empty."""
    sp = _surface(pred > 0.5)
    sg = _surface(target > 0.5)
    d_to_gt = _edt_sq_2d(sg).clamp(min=0).sqrt()
    d_to_pr = _edt_sq_2d(sp).clamp(min=0).sqrt()
    fwd = _masked_percentile(d_to_gt.flatten(-2), sp.flatten(-2), percentile)
    bwd = _masked_percentile(d_to_pr.flatten(-2), sg.flatten(-2), percentile)
    out = torch.maximum(fwd, bwd)
    empty = ~sp.flatten(-2).any(-1) | ~sg.flatten(-2).any(-1)
    return torch.where(empty, torch.full_like(out, float("nan")), out)


def hausdorff_distance_95(pred: torch.Tensor, target: torch.Tensor,
                          percentile: float = 95.0) -> torch.Tensor:
    """Symmetric HD percentile of one (H, W) binary pair (a scalar); NaN if
    either mask is empty."""
    return hd95_batch(pred[None], target[None], percentile)[0]


def nanmean(values: torch.Tensor) -> torch.Tensor:
    """Mean over the entries that are not NaN (0 where all are)."""
    ok = ~values.isnan()
    return torch.where(ok, values, 0.0).sum() / ok.sum().clamp(min=1)
