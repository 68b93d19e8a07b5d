"""YOLO building blocks in PyTorch (NCHW) with ultralytics state_dict names.

Counterparts of `yolou_tpu/nn/blocks.py`. Parameters stay float32; the
compute dtype is the dtype of the input. As in the JAX package a conv runs in
the compute dtype (accumulating in f32 inside cuDNN / the CPU kernel), its
BatchNorm runs in float32, and the result is cast back. The TPU layout
rewrites there (lazy concat tuples, `LazyUpsample2x`, `_dual_entry_1x1`, the
s2d stem) compute the same function and are not carried over.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# ultralytics BatchNorm constants (torch momentum 0.03 == flax 0.97)
BN_EPS = 1e-3
BN_MOMENTUM = 0.03


def autopad(k: int, p: int | None = None, d: int = 1) -> int:
    """'same'-style padding for odd kernels (YOLO Conv default)."""
    if d > 1:
        k = d * (k - 1) + 1
    return k // 2 if p is None else p


def conv_in_dtype(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Run a Conv2d with its f32 parameters cast to the input's dtype."""
    b = None if m.bias is None else m.bias.to(x.dtype)
    return m._conv_forward(x, m.weight.to(x.dtype), b)


class BatchNorm2d(nn.BatchNorm2d):
    """`torch.nn.BatchNorm2d` whose running variance follows flax's
    `nn.BatchNorm`, as the JAX package's does: in training mode the running
    variance takes in the *biased* batch variance, where torch takes the
    unbiased one (a factor n / (n - 1), n = values per channel). Outputs,
    gradients, the running mean, eval mode and the state_dict keys are
    torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        n = x.numel() // x.shape[1]
        m = self.momentum
        # torch folds the unbiased variance u into the buffer it is handed:
        # new = (1-m) old + m u. Hand it a copy (autograd keeps that one),
        # then write (1-m) old + m u (n-1)/n into the real buffer.
        new = self.running_var.clone()
        y = F.batch_norm(x, self.running_mean, new, self.weight, self.bias,
                         True, m, self.eps)
        self.running_var.mul_(1.0 - m).lerp_(new, 1.0 - 1.0 / n)
        self.num_batches_tracked.add_(1)
        return y


class Conv(nn.Module):
    """Conv2d (no bias) + BatchNorm2d + SiLU: ultralytics `Conv`, JAX
    `ConvBNAct`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 d: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, autopad(k, None, d), dilation=d,
                              groups=g, bias=False)
        self.bn = BatchNorm2d(c2, eps=BN_EPS, momentum=BN_MOMENTUM)
        self.act = nn.SiLU() if act else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(conv_in_dtype(self.conv, x).float())
        return self.act(y).to(x.dtype)

    def folded(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """BatchNorm folded into the conv with running stats: (W', b'), f32.
        Same as the JAX package's `FoldedConvBN`."""
        bn = self.bn
        inv = bn.weight * torch.rsqrt(bn.running_var + bn.eps)
        w = self.conv.weight * inv[:, None, None, None]
        return w, bn.bias - bn.running_mean * inv


class DWConv(Conv):
    """Depthwise conv (groups = gcd(c1, c2)), ultralytics `DWConv`."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, d: int = 1,
                 act: bool = True):
        super().__init__(c1, c2, k, s, g=math.gcd(c1, c2), d=d, act=act)


class Bottleneck(nn.Module):
    """cv1 kxk -> cv2 kxk with a residual when the widths agree."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1,
                 k: Tuple[int, int] = (3, 3), e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, k: Tuple[int, int] = (1, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k=k, e=1.0)
                                 for _ in range(n)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    """C3 with kxk bottleneck kernels (C3k2 with c3k=True, and A2C2f's neck
    stages)."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 g: int = 1, e: float = 0.5, k: int = 3):
        super().__init__(c1, c2, n, shortcut, g, e, k=(k, k))


class C3k2(nn.Module):
    """v11/v12 C2f variant whose inner blocks are C3k (c3k=True) or
    Bottleneck."""

    def __init__(self, c1: int, c2: int, n: int = 1, c3k: bool = False,
                 e: float = 0.5, g: int = 1, shortcut: bool = True):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k
            else Bottleneck(self.c, self.c, shortcut, g, k=(3, 3), e=0.5)
            for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class Proto(nn.Module):
    """Mask prototypes: conv3x3 -> 2x transposed conv -> conv3x3 -> 1x1."""

    def __init__(self, c1: int, c_: int = 256, c2: int = 32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        up = self.upsample
        x = F.conv_transpose2d(x, up.weight.to(x.dtype), up.bias.to(x.dtype),
                               stride=2)
        return self.cv3(self.cv2(x))


class Concat(nn.Module):
    """Channel concat of several earlier layers (parameter-free)."""

    def forward(self, xs) -> torch.Tensor:
        return torch.cat(list(xs), 1)


# ------------------------------------------------- YOLO-Seg++ decoder blocks

class LightConv(nn.Module):
    """1x1 Conv (no activation) followed by a depthwise kxk Conv."""

    def __init__(self, c1: int, c2: int, k: int = 3, act: bool = True):
        super().__init__()
        self.conv1 = Conv(c1, c2, 1, act=False)
        self.conv2 = DWConv(c2, c2, k, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class GhostConv(nn.Module):
    """Ghost convolution: a primary conv to half the width and a cheap
    depthwise 5x5 on its output, concatenated."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, g: int = 1,
                 act: bool = True):
        super().__init__()
        c_ = c2 // 2
        self.cv1 = Conv(c1, c_, k, s, g=g, act=act)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv1(x)
        return torch.cat([y, self.cv2(y)], 1)


class GhostBottleneck(nn.Module):
    """Ghost bottleneck, stride 1 or 2. `conv` is ultralytics' 3-slot
    Sequential (GhostConv, DWConv at stride 2 or Identity, GhostConv), so the
    second GhostConv is `conv.2` at either stride; the shortcut is a
    depthwise + pointwise pair at stride 2, the input where the widths agree
    at stride 1, and nothing otherwise."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1):
        super().__init__()
        c_ = c2 // 2
        self.conv = nn.Sequential(
            GhostConv(c1, c_, 1, 1),
            DWConv(c_, c_, k, s, act=False) if s == 2 else nn.Identity(),
            GhostConv(c_, c2, 1, 1, act=False))
        self.shortcut = (nn.Sequential(DWConv(c1, c1, k, s, act=False),
                                       Conv(c1, c2, 1, 1, act=False))
                         if s == 2 else nn.Identity())
        self.add = s == 2 or c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y + self.shortcut(x) if self.add else y


class C3Ghost(C3):
    """C3 with GhostBottleneck blocks: the decoder's mixing block."""

    def __init__(self, c1: int, c2: int, n: int = 1, e: float = 0.5):
        super().__init__(c1, c2, 0, e=e)
        c_ = int(c2 * e)
        self.m = nn.Sequential(*(GhostBottleneck(c_, c_) for _ in range(n)))


class ECA(nn.Module):
    """Efficient channel attention: global average pool (f32), a 1D conv of
    width k over the channel axis without bias, a sigmoid gate."""

    def __init__(self, k: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(1, 1, k, padding=(k - 1) // 2, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.float().mean((2, 3))                         # (B, C)
        gate = torch.sigmoid(self.conv(y[:, None])[:, 0])
        return x * gate[:, :, None, None].to(x.dtype)


def _residual_conv(c1: int, c2: int) -> nn.Module:
    """1x1 projection with bias where the widths differ, else the input."""
    return nn.Conv2d(c1, c2, 1) if c1 != c2 else nn.Identity()


def _project(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return conv_in_dtype(m, x) if isinstance(m, nn.Conv2d) else m(x)


class SingleLightConv(nn.Module):
    """LightConv plus a 1x1 residual projection."""

    def __init__(self, c1: int, c2: int, k: int = 3):
        super().__init__()
        self.conv = LightConv(c1, c2, k)
        self.residual_conv = _residual_conv(c1, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + _project(self.residual_conv, x)


class DoubleLightConv(nn.Module):
    """Two stacked LightConvs plus a 1x1 residual projection."""

    def __init__(self, c1: int, c2: int, k1: int = 3, k2: int = 3):
        super().__init__()
        self.conv = nn.Sequential(LightConv(c1, c2, k1), LightConv(c2, c2, k2))
        self.residual_conv = _residual_conv(c1, c2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x) + _project(self.residual_conv, x)


def upsample_bilinear_torch(x: torch.Tensor,
                            out_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of NCHW `x` with half-pixel centres
    (`align_corners=False`), the JAX package's function of the same name."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)
