"""Detect / Segment heads (YOLOv8-v12) in PyTorch, NCHW.

Counterparts of `yolou_tpu/nn/heads.py`, computed in the staged form: per
level a box branch (2x Conv3x3 -> 1x1 to 4*reg_max), a class branch
(2x [DWConv3x3 + Conv1x1] -> 1x1 to nc; with `legacy`, the v8 family's
2x Conv3x3 -> 1x1) and, for Segment, a mask-coefficient branch and the
Proto module. The JAX eval path batches sibling entry convs
into one wider conv; that is a TPU rewrite of the same function.
"""

from __future__ import annotations

import re
from typing import List, Sequence

import torch
from torch import nn

from ..ops.boxes import dfl_decode, dist2bbox, make_anchors
from .blocks import Conv, DWConv, Proto, conv_in_dtype


class DFL(nn.Module):
    """ultralytics' fixed DFL projection (weights arange(reg_max)). Kept for
    checkpoint key parity; `decode_detections` applies the same expectation
    arithmetically."""

    def __init__(self, c1: int = 16):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)
        with torch.no_grad():
            self.conv.weight.copy_(
                torch.arange(c1, dtype=torch.float32).view(1, c1, 1, 1))


class Detect(nn.Module):
    """Anchor-free detection head over (P3, P4, P5); returns raw NCHW maps
    with channels [4*reg_max box distribution | nc class logits].
    `legacy` is ultralytics' `Detect.legacy`: the class branch of the v8
    family, plain Conv3x3 stages (`cv3.i.0.conv`) where v11/v12 nest a
    DWConv and a 1x1 Conv in each stage (`cv3.i.0.0.conv`)."""

    def __init__(self, nc: int = 80, ch: Sequence[int] = (), reg_max: int = 16,
                 legacy: bool = False):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(
            nn.Sequential(Conv(x, c2, 3), Conv(c2, c2, 3),
                          nn.Conv2d(c2, 4 * reg_max, 1)) for x in ch)
        self.cv3 = nn.ModuleList(
            nn.Sequential(Conv(x, c3, 3), Conv(c3, c3, 3),
                          nn.Conv2d(c3, nc, 1)) if legacy
            else nn.Sequential(
                nn.Sequential(DWConv(x, x, 3), Conv(x, c3, 1)),
                nn.Sequential(DWConv(c3, c3, 3), Conv(c3, c3, 1)),
                nn.Conv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL(reg_max)

    @staticmethod
    def _branch(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        *convs, last = seq
        for m in convs:
            x = m(x)
        return conv_in_dtype(last, x)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [torch.cat([self._branch(self.cv2[i], x),
                           self._branch(self.cv3[i], x)], 1)
                for i, x in enumerate(feats)]


class Segment(Detect):
    """Detect + mask-coefficient branch + Proto.

    Returns (raw maps, mask_coefs (B, N, nm), protos (B, nm, Hm, Wm))."""

    def __init__(self, nc: int = 80, nm: int = 32, npr: int = 256,
                 ch: Sequence[int] = (), reg_max: int = 16,
                 legacy: bool = False):
        super().__init__(nc, ch, reg_max, legacy)
        self.nm, self.npr = nm, npr
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(
            nn.Sequential(Conv(x, c4, 3), Conv(c4, c4, 3),
                          nn.Conv2d(c4, nm, 1)) for x in ch)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, feats: Sequence[torch.Tensor]):
        protos = self.proto(feats[0])
        raw = super().forward(feats)
        mc = torch.cat([self._branch(self.cv4[i], x).flatten(2)
                        for i, x in enumerate(feats)], 2)
        return raw, mc.transpose(1, 2), protos


def decode_detections(raw: Sequence[torch.Tensor], strides: Sequence[int],
                      nc: int, reg_max: int = 16) -> torch.Tensor:
    """Raw per-level NCHW maps -> (B, N, 4+nc) f32: xywh boxes in input
    pixels and sigmoid class scores (the tensor NMS consumes)."""
    anchors, stride_t = make_anchors([r.shape[2:] for r in raw], strides,
                                     0.5, device=raw[0].device)
    flat = torch.cat([r.flatten(2) for r in raw], 2).transpose(1, 2).float()
    dist = dfl_decode(flat[..., :4 * reg_max], reg_max)
    dbox = dist2bbox(dist, anchors[None], xywh=True) * stride_t[None]
    return torch.cat([dbox, torch.sigmoid(flat[..., 4 * reg_max:])], -1)


@torch.no_grad()
def warm_start_detect_bias(model: nn.Module, reg_max: int = 16,
                           box_bin: int = 4, cls_logit: float = 2.0):
    """Bias the head's final convs so a random init already gives confident
    class scores and moderate box extents (in place; returns the model).
    Same rule as the JAX package's `warm_start_detect_bias`: every
    `cv3.i.2.bias` becomes `cls_logit`, every `cv2.i.2.bias` one-hot at
    `box_bin` per side with value 4."""
    for name, p in model.named_parameters():
        if re.search(r"(^|\.)cv3\.\d+\.2\.bias$", name):
            p.fill_(cls_logit)
        elif (re.search(r"(^|\.)cv2\.\d+\.2\.bias$", name)
              and p.shape[-1] == 4 * reg_max):
            p.zero_()
            p.view(4, reg_max)[:, box_bin] = 4.0
    return model
