"""Plain PyTorch YOLO-Seg++ decoder, the benchmark's own reference.

Written from the YOLO-Seg++ reference's decoder (Jhewu/YOLO-U, `train.py`):
at stride 8 concat [skip of layer 4, conditioning map] -> C3Ghost(96) +
ECA; bilinear x2 -> DoubleLightConv(64); concat skip of layer 2 ->
C3Ghost(64) + ECA; x2 -> DoubleLightConv(32); x2 -> DoubleLightConv(16);
a 1x1 conv to one logit channel at full resolution. In the fused pass the
conditioning map is the sigmoid of the stride-8 head map's last channel
(the class logit) with no z-score; in decoder training it is given. The
encoder is the detector's layers 0-4, frozen and in inference mode.
Module names are the reference's (`yolo.model.{i}`, `decoder.{i}.{j}`,
`output`). Imports nothing of the program.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .yolo import YOLO, Conv, plain_conv

SKIPS = (2, 4)
ENCODER_LAYERS = 5


class LightConv(nn.Module):
    def __init__(self, c1, c2, k=3, act=True):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = Conv(c2, c2, k, g=c2, act=act)

    def forward(self, x):
        return self.conv2(self.conv1(x))


class GhostConv(nn.Module):
    def __init__(self, c1, c2, k=1, s=1, act=True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x):
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Stride 1: GhostConv, GhostConv without activation, plus the input."""

    def __init__(self, c1, c2):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(GhostConv(c1, c_), nn.Identity(),
                                  GhostConv(c_, c2, act=False))
        self.add = c1 == c2

    def forward(self, x):
        y = self.conv(x)
        return y + x if self.add else y


class C3Ghost(nn.Module):
    def __init__(self, c1, c2, n=1, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class ECA(nn.Module):
    """Global average pool in float32, a width-3 1D conv over channels
    without bias, a sigmoid gate."""

    def __init__(self, k=3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x):
        y = x.float().mean((2, 3))
        gate = torch.sigmoid(F.conv1d(y[:, None], self.conv.weight,
                                      padding=self.conv.padding)[:, 0])
        return x * gate[:, :, None, None].to(x.dtype)


class DoubleLightConv(nn.Module):
    def __init__(self, c1, c2, k1=3, k2=3):
        super().__init__()
        self.conv = nn.Sequential(LightConv(c1, c2, k1), LightConv(c2, c2, k2))
        self.residual_conv = nn.Conv2d(c1, c2, 1) if c1 != c2 else None

    def forward(self, x):
        r = x if self.residual_conv is None else plain_conv(
            self.residual_conv, x)
        return self.conv(x) + r


class Upsample2x(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


class SegPP(nn.Module):
    """The frozen yolov12 graph and the decoder. `forward(x)` is the fused
    pass (mask logits, the detector's outputs); `forward(x, logits)` runs
    the encoder slice only and decodes with the given conditioning map."""

    def __init__(self, variant: str = "n", nc: int = 1, ch: int = 4,
                 task: str = "detect"):
        super().__init__()
        self.yolo = YOLO(variant, nc, ch, task)
        c2, c4 = (self.yolo.channels[i + 1] for i in SKIPS)
        self.decoder = nn.ModuleList([
            nn.Sequential(C3Ghost(c4 + 1, 96, 1), ECA()),
            nn.Sequential(Upsample2x(), DoubleLightConv(96, 64)),
            nn.Sequential(C3Ghost(64 + c2, 64, 1), ECA()),
            nn.Sequential(Upsample2x(), DoubleLightConv(64, 32)),
            nn.Sequential(Upsample2x(), DoubleLightConv(32, 16))])
        self.output = nn.Conv2d(16, 1, 1)

    def train(self, mode: bool = True):
        super().train(mode)
        self.yolo.eval()
        return self

    def decode_mask(self, skip2, skip4, logits):
        d = self.decoder
        x = d[1](d[0](torch.cat([skip4, logits.to(skip4.dtype)], 1)))
        x = d[4](d[3](d[2](torch.cat([x, skip2], 1))))
        return plain_conv(self.output, x).float()

    def forward(self, x: torch.Tensor, logits: Optional[torch.Tensor] = None):
        full = logits is None
        with torch.no_grad():
            raw, preds, mc, protos, taps = self.yolo(
                x, SKIPS, None if full else ENCODER_LAYERS)
            if full:
                logits = torch.sigmoid(raw[0][:, -1:].float())
        mask = self.decode_mask(taps[SKIPS[0]].detach(),
                                taps[SKIPS[1]].detach(), logits)
        return mask, (raw, preds, mc, protos)
