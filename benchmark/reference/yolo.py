"""Plain PyTorch YOLOv12 (detect and segment heads), the benchmark's own
reference of the detector's forward pass.

Written from ultralytics' module definitions (`nn/modules/block.py`:
Conv, Bottleneck, C3, C3k, C2f, C3k2, AAttn, ABlock, A2C2f; `head.py`:
Detect, Segment, Proto, DFL) over the rows of `cfg/models/12/yolo12.yaml`,
with the module tree and state_dict names of ultralytics, so that one
state_dict loads here and into the program alike. It imports nothing of
the program: no kernel, no folded weight, no cache. Departures from
ultralytics, each the program's documented behaviour that the benchmark
holds it to:
- a layer computes in the dtype of its input; a convolution's BatchNorm
  and activation in float32, the result cast back (`Conv.forward`);
- area attention computes its scores, softmax and p.v in float32, the
  probabilities rounded to the compute dtype (the kernels' contract);
- a band count that does not divide the tokens falls back to one band.
The scales are those at which ultralytics' `parse_model` applies none of
its scale rules (C3k2 `c3k=True` at m/l/x; A2C2f `residual=True,
mlp_ratio=1.2` at l/x), so that the yaml rows are the published model:
`YOLO` refuses m, l and x, which this file does not write.

`Conv.fp8` (off) rounds a convolution's operands, and `AAttn.fp8` the
attention's, to float8 e4m3 with one scale per tensor: the precision
below bfloat16 that the control of a bfloat16 configuration runs in.
`BatchNorm.calibrating` makes a BatchNorm take its input's batch
statistics as its running ones (`weights.py` draws weights with it).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-3
E4M3_MAX = 448.0

# ultralytics cfg/models/12/yolo12.yaml: (from, repeats, module, args)
BACKBONE = [
    (-1, 1, "Conv", [64, 3, 2]),
    (-1, 1, "Conv", [128, 3, 2]),
    (-1, 2, "C3k2", [256, False, 0.25]),
    (-1, 1, "Conv", [256, 3, 2]),
    (-1, 2, "C3k2", [512, False, 0.25]),
    (-1, 1, "Conv", [512, 3, 2]),
    (-1, 4, "A2C2f", [512, True, 4]),
    (-1, 1, "Conv", [1024, 3, 2]),
    (-1, 4, "A2C2f", [1024, True, 1]),
]
HEAD = [
    (-1, 1, "Upsample", [2]),
    ((-1, 6), 1, "Concat", []),
    (-1, 2, "A2C2f", [512, False, -1]),
    (-1, 1, "Upsample", [2]),
    ((-1, 4), 1, "Concat", []),
    (-1, 2, "A2C2f", [256, False, -1]),
    (-1, 1, "Conv", [256, 3, 2]),
    ((-1, 11), 1, "Concat", []),
    (-1, 2, "A2C2f", [512, False, -1]),
    (-1, 1, "Conv", [512, 3, 2]),
    ((-1, 8), 1, "Concat", []),
    (-1, 2, "C3k2", [1024, True]),
    ((14, 17, 20), 1, "HEAD", []),
]
# depth, width, max channels (the yaml's n and s)
SCALES = {"n": (0.50, 0.25, 1024), "s": (0.50, 0.50, 1024)}
STRIDES = (8, 16, 32)


def qdq_e4m3(t: torch.Tensor) -> torch.Tensor:
    """`t` rounded to float8 e4m3 under one scale (its largest magnitude
    maps to 448), returned in its own dtype."""
    s = t.detach().abs().amax().float().clamp(min=1e-30) / E4M3_MAX
    return (t.float() / s).to(torch.float8_e4m3fn).float().mul(s).to(t.dtype)


def channels(c: int, width: float, max_ch: int) -> int:
    return int(math.ceil(min(c, max_ch) * width / 8) * 8)


def repeats(n: int, depth: float) -> int:
    return max(round(n * depth), 1) if n > 1 else n


class BatchNorm(nn.Module):
    """BatchNorm over float32 input, torch's state_dict names. In training
    mode it normalises by the batch's mean and biased variance and moves
    its running statistics by `momentum` towards them (flax's rule, the
    biased variance, as the program's BatchNorm2d does)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))
        self.calibrating = False
        self.momentum = 0.03

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            mean = x.mean((0, 2, 3))
            var = x.var((0, 2, 3), unbiased=False)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
                self.num_batches_tracked.add_(1)
            shape = (1, -1, 1, 1)
            return ((x - mean.view(shape))
                    * torch.rsqrt(var + BN_EPS).view(shape)
                    * self.weight.view(shape) + self.bias.view(shape))
        if self.calibrating:
            with torch.no_grad():
                self.running_mean.copy_(x.mean((0, 2, 3)))
                self.running_var.copy_(x.var((0, 2, 3), unbiased=False))
        return F.batch_norm(x, self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


class Conv(nn.Module):
    """Conv2d without bias, BatchNorm, SiLU (ultralytics `Conv`)."""

    def __init__(self, c1, c2, k=1, s=1, g=1, act=True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = BatchNorm(c2)
        self.act = act
        self.fp8 = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight.to(x.dtype)
        xin = x
        if self.fp8:
            xin, w = qdq_e4m3(x), qdq_e4m3(w)
        c = self.conv
        y = self.bn(F.conv2d(xin, w, None, c.stride, c.padding, c.dilation,
                             c.groups).float())
        return (F.silu(y) if self.act else y).to(x.dtype)


def plain_conv(m: nn.Conv2d, x: torch.Tensor, fp8: bool = False):
    """An nn.Conv2d with bias in the input's dtype."""
    w = m.weight.to(x.dtype)
    if fp8:
        x, w = qdq_e4m3(x), qdq_e4m3(w)
    b = None if m.bias is None else m.bias.to(x.dtype)
    return F.conv2d(x, w, b, m.stride, m.padding, m.dilation, m.groups)


class Bottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, g=1, k=(3, 3), e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, k[0], 1)
        self.cv2 = Conv(c_, c2, k[1], 1, g=g)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=(1, 3)):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1)
        self.cv2 = Conv(c1, c_, 1)
        self.cv3 = Conv(2 * c_, c2, 1)
        self.m = nn.Sequential(*(Bottleneck(c_, c_, shortcut, g, k, 1.0)
                                 for _ in range(n)))

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class C3k(C3):
    def __init__(self, c1, c2, n=1, shortcut=True, g=1, e=0.5, k=3):
        super().__init__(c1, c2, n, shortcut, g, e, (k, k))


class C2f(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=False, g=1, e=0.5):
        super().__init__()
        self.c = int(c2 * e)
        self.cv1 = Conv(c1, 2 * self.c, 1)
        self.cv2 = Conv((2 + n) * self.c, c2, 1)
        self.m = nn.ModuleList(Bottleneck(self.c, self.c, shortcut, g,
                                          (3, 3), 1.0) for _ in range(n))

    def forward(self, x):
        y = list(self.cv1(x).chunk(2, 1))
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class C3k2(C2f):
    def __init__(self, c1, c2, n=1, c3k=False, e=0.5, g=1, shortcut=True):
        super().__init__(c1, c2, n, shortcut, g, e)
        self.m = nn.ModuleList(
            C3k(self.c, self.c, 2, shortcut, g) if c3k
            else Bottleneck(self.c, self.c, shortcut, g, (3, 3), 0.5)
            for _ in range(n))


class AAttn(nn.Module):
    """Area attention as ultralytics writes it: qkv 1x1 conv whose channels
    are head-major [q | k | v] per head, softmax attention within each of
    `area` bands of tokens, a depthwise 7x7 positional term on v, a 1x1
    projection."""

    def __init__(self, dim, num_heads, area=1):
        super().__init__()
        self.area, self.num_heads = area, num_heads
        self.head_dim = dim // num_heads
        self.qkv = Conv(dim, dim * 3, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)
        self.fp8 = False

    def forward(self, x):
        B, C, H, W = x.shape
        N = H * W
        area = self.area if N % self.area == 0 else 1
        hd = self.head_dim
        qkv = self.qkv(x).flatten(2).transpose(1, 2)
        qkv = qkv.reshape(B * area, N // area, 3 * C)
        q, k, v = qkv.view(B * area, N // area, self.num_heads,
                           3 * hd).permute(0, 2, 3, 1).split([hd] * 3, 2)
        if self.fp8:
            q, k, v = qdq_e4m3(q), qdq_e4m3(k), qdq_e4m3(v)
        s = (q.transpose(-2, -1).float() @ k.float()) * hd ** -0.5
        p = s.softmax(-1).to(x.dtype)
        if self.fp8:
            p = qdq_e4m3(p)
        o = (v.float() @ p.float().transpose(-2, -1)).to(x.dtype)
        o = o.permute(0, 3, 1, 2).reshape(B, N, C)
        v = v.permute(0, 3, 1, 2).reshape(B, N, C)

        def spatial(t):
            return t.reshape(B, H, W, C).permute(0, 3, 1, 2)

        return self.proj(spatial(o) + self.pe(spatial(v)))


class ABlock(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio=2.0, area=1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        h = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, h, 1), Conv(h, dim, 1, act=False))

    def forward(self, x):
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    def __init__(self, c1, c2, n=1, a2=True, area=1, mlp_ratio=2.0, e=0.5,
                 g=1, shortcut=True):
        super().__init__()
        c_ = int(c2 * e)
        heads = max(1, c_ // 32)
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, heads, mlp_ratio, area)
                            for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut, g) for _ in range(n))

    def forward(self, x):
        y = [self.cv1(x)]
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))


class DFL(nn.Module):
    """Holds ultralytics' fixed projection (arange(reg_max)) for the
    state_dict; `decode` takes the expectation over the same bins."""

    def __init__(self, c1=16):
        super().__init__()
        self.conv = nn.Conv2d(c1, 1, 1, bias=False).requires_grad_(False)


class Proto(nn.Module):
    def __init__(self, c1, c_=256, c2=32):
        super().__init__()
        self.cv1 = Conv(c1, c_, 3)
        self.upsample = nn.ConvTranspose2d(c_, c_, 2, 2, 0, bias=True)
        self.cv2 = Conv(c_, c_, 3)
        self.cv3 = Conv(c_, c2)
        self.fp8 = False

    def forward(self, x):
        x = self.cv1(x)
        w, b = self.upsample.weight.to(x.dtype), self.upsample.bias
        if self.fp8:
            x, w = qdq_e4m3(x), qdq_e4m3(w)
        x = F.conv_transpose2d(x, w, b.to(x.dtype), 2)
        return self.cv3(self.cv2(x))


class Detect(nn.Module):
    """Box branch (2x Conv3x3, 1x1 to 4*reg_max) and class branch
    (2x [DWConv3x3, Conv1x1], 1x1 to nc) per level; raw NCHW maps."""

    def __init__(self, nc, ch, reg_max=16):
        super().__init__()
        self.nc, self.reg_max = nc, reg_max
        c2 = max(16, ch[0] // 4, reg_max * 4)
        c3 = max(ch[0], min(nc, 100))
        self.cv2 = nn.ModuleList(nn.Sequential(
            Conv(x, c2, 3), Conv(c2, c2, 3), nn.Conv2d(c2, 4 * reg_max, 1))
            for x in ch)
        self.cv3 = nn.ModuleList(nn.Sequential(
            nn.Sequential(Conv(x, x, 3, g=x), Conv(x, c3, 1)),
            nn.Sequential(Conv(c3, c3, 3, g=c3), Conv(c3, c3, 1)),
            nn.Conv2d(c3, nc, 1)) for x in ch)
        self.dfl = DFL(reg_max)
        self.fp8 = False

    def branch(self, seq, x):
        *convs, last = seq
        for m in convs:
            x = m(x)
        return plain_conv(last, x, self.fp8)

    def forward(self, feats):
        return [torch.cat([self.branch(self.cv2[i], x),
                           self.branch(self.cv3[i], x)], 1)
                for i, x in enumerate(feats)]


class Segment(Detect):
    def __init__(self, nc, nm, npr, ch, reg_max=16):
        super().__init__(nc, ch, reg_max)
        self.nm = nm
        c4 = max(ch[0] // 4, nm)
        self.cv4 = nn.ModuleList(nn.Sequential(
            Conv(x, c4, 3), Conv(c4, c4, 3), nn.Conv2d(c4, nm, 1))
            for x in ch)
        self.proto = Proto(ch[0], npr, nm)

    def forward(self, feats):
        protos = self.proto(feats[0])
        raw = super().forward(feats)
        mc = torch.cat([self.branch(self.cv4[i], x).flatten(2)
                        for i, x in enumerate(feats)], 2)
        return raw, mc.transpose(1, 2), protos


def decode(raw: Sequence[torch.Tensor], nc: int, reg_max: int = 16
           ) -> torch.Tensor:
    """Raw maps -> (B, N, 4 + nc) float32: xywh boxes in input pixels from
    the DFL expectation about each anchor (cell centre), sigmoid scores."""
    pts, strides = [], []
    for r, s in zip(raw, STRIDES):
        h, w = r.shape[2:]
        gy, gx = torch.meshgrid(torch.arange(h, device=r.device) + 0.5,
                                torch.arange(w, device=r.device) + 0.5,
                                indexing="ij")
        pts.append(torch.stack([gx.flatten(), gy.flatten()], -1))
        strides.append(torch.full((h * w, 1), float(s), device=r.device))
    anchors, stride = torch.cat(pts).float(), torch.cat(strides)
    flat = torch.cat([r.flatten(2) for r in raw], 2).transpose(1, 2).float()
    bins = torch.arange(reg_max, device=flat.device, dtype=torch.float32)
    dist = (flat[..., :4 * reg_max].unflatten(-1, (4, reg_max)).softmax(-1)
            * bins).sum(-1)
    lt, rb = dist.chunk(2, -1)
    x1y1, x2y2 = anchors - lt, anchors + rb
    box = torch.cat([(x1y1 + x2y2) / 2, x2y2 - x1y1], -1) * stride
    return torch.cat([box, torch.sigmoid(flat[..., 4 * reg_max:])], -1)


class YOLO(nn.Module):
    """The yolov12 graph at one scale; `forward` returns (raw maps, preds,
    mask coefficients, protos, taps). `taps` are the outputs of the given
    layers, `stop_at` stops before that layer."""

    def __init__(self, variant: str, nc: int, ch: int, task: str):
        super().__init__()
        if variant not in SCALES:
            raise NotImplementedError(
                f"scale {variant!r}: ultralytics' scale rules at m/l/x are "
                "not written here")
        depth, width, max_ch = SCALES[variant]
        self.nc, self.task = nc, task
        self.rows = []
        chs = [ch]
        mods = []
        for frm, n, kind, args in BACKBONE + HEAD:
            frm = frm if isinstance(frm, tuple) else (frm,)
            cin = chs[frm[0] + 1] if frm[0] != -1 else chs[-1]
            n = repeats(n, depth)
            if kind == "Conv":
                c2 = channels(args[0], width, max_ch)
                m = Conv(cin, c2, args[1], args[2])
            elif kind == "C3k2":
                c2 = channels(args[0], width, max_ch)
                m = C3k2(cin, c2, n, args[1],
                         args[2] if len(args) > 2 else 0.5)
            elif kind == "A2C2f":
                c2 = channels(args[0], width, max_ch)
                m = A2C2f(cin, c2, n, args[1], max(args[2], 1))
            elif kind == "Upsample":
                c2, m = cin, nn.Upsample(scale_factor=2, mode="nearest")
            elif kind == "Concat":
                c2 = sum(chs[j + 1] if j != -1 else chs[-1] for j in frm)
                m = nn.Identity()
            else:
                c2 = 0
                feats = [chs[j + 1] for j in frm]
                m = (Segment(nc, 32, channels(256, width, max_ch), feats)
                     if task == "segment" else Detect(nc, feats))
            self.rows.append((frm, kind))
            mods.append(m)
            chs.append(c2)
        self.model = nn.ModuleList(mods)
        self.channels = chs

    def forward(self, x: torch.Tensor, taps: Sequence[int] = (),
                stop_at: Optional[int] = None):
        ys: List[torch.Tensor] = []
        tapped = {}
        head = None

        def get(j):
            return ys[j] if j != -1 else (ys[-1] if ys else x)

        for i, ((frm, kind), m) in enumerate(zip(self.rows, self.model)):
            if stop_at is not None and i >= stop_at:
                break
            if kind == "Concat":
                y = torch.cat([get(j) for j in frm], 1)
            elif kind == "HEAD":
                feats = [get(j) for j in frm]
                head = (m(feats) if self.task == "segment"
                        else (m(feats), None, None))
                y = feats[0]
            else:
                y = m(get(frm[0]))
            ys.append(y)
            if i in taps:
                tapped[i] = y
        if head is None:
            return None, None, None, None, tapped
        raw, mc, protos = head
        preds = decode(raw, self.nc)
        if mc is not None:
            preds = torch.cat([preds, mc.float()], -1)
        return tuple(raw), preds, mc, protos, tapped


def set_fp8(model: nn.Module, on: bool = True) -> nn.Module:
    """Round every convolution's and attention's operands to e4m3."""
    for m in model.modules():
        if hasattr(m, "fp8"):
            m.fp8 = on
    return model


def conv_modules(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d))]
