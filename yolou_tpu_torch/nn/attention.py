"""YOLOv12 area attention (AAttn / ABlock / A2C2f) in PyTorch, NCHW.

Counterparts of `yolou_tpu/nn/attention.py`. "Area" attention splits the
H*W tokens into `area` contiguous bands and attends within each band.

At eval AAttn takes the JAX package's fused path: the qkv 1x1 conv and its
BatchNorm fold into one affine (C, 3C) whose output channels are permuted to
role-major q | k | v thirds, and `kernels.attention.area_attention_qkv_fused`
computes the projection and the per-head band softmax attention in one
kernel. In training mode the qkv conv and its BatchNorm (batch statistics)
run unfolded and `kernels.attention.area_attention_fused` attends over their
output. The module itself holds qkv in ultralytics' head-major interleave,
so released checkpoints load unchanged; the permutation to the kernels'
role-major layout is applied to the folded weight at eval and to the conv's
output channels (as a strided copy) in training.

A2C2f built with `mega_kernel=True` hands a whole attention block at eval to
`kernels.a2c2f.a2c2f_fused` where the shape passes `a2c2f_mega_eligible`:
every Conv of the block folds into an affine GEMM and the block runs as one
kernel launch. The state_dict is the same with the flag on or off.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
from torch import nn

from ..kernels.a2c2f import a2c2f_fused, a2c2f_mega_eligible
from ..kernels.attention import (area_attention_fused,
                                 area_attention_qkv_fused)
from .blocks import C3k, Conv


def aattn_qkv_permutation(c3: int, hd: int = 32) -> np.ndarray:
    """Output-channel permutation of AAttn's qkv conv, head-major interleave
    (channel h*3*hd + role*hd + d, ultralytics) -> role-major thirds
    (channel role*C + h*hd + d, the kernel's layout): perm[ours] = theirs."""
    c = c3 // 3
    heads = c // hd
    perm = np.empty(c3, np.int64)
    for role in range(3):
        for h in range(heads):
            base = role * c + h * hd
            perm[base:base + hd] = h * 3 * hd + role * hd + np.arange(hd)
    return perm


class AAttn(nn.Module):
    """Area attention: qkv 1x1 conv, band softmax attention, dw7x7 positional
    term on v, 1x1 projection."""

    def __init__(self, dim: int, num_heads: int, area: int = 1):
        super().__init__()
        self.area = area
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = Conv(dim, dim * 3, 1, act=False)
        self.proj = Conv(dim, dim, 1, act=False)
        self.pe = Conv(dim, dim, 7, 1, g=dim, act=False)
        self.register_buffer(
            "perm", torch.from_numpy(aattn_qkv_permutation(3 * dim,
                                                           self.head_dim)),
            persistent=False)

    def folded_qkv(self, dtype: torch.dtype):
        """(w (C, 3C) in `dtype`, b (3C,) f32): BN-folded qkv affine with
        role-major output thirds, exactly the JAX kernel's operands."""
        w, b = self.qkv.folded()
        w = w[self.perm, :, 0, 0]
        return w.t().contiguous().to(dtype), b[self.perm].contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        n = H * W
        area = self.area if n % self.area == 0 else 1
        if self.training:
            # the conv's channels are (head, role, d): taking one role of
            # every head is the permutation to role-major, as a strided copy
            tokens = self.qkv(x).flatten(2).transpose(1, 2).reshape(
                B * area, n // area, self.num_heads, 3, self.head_dim)
            q, k, v = (tokens[..., role, :].reshape(B * area, n // area, C)
                       for role in range(3))
            o = area_attention_fused(q, k, v, self.num_heads)
        else:
            w, b = self.folded_qkv(x.dtype)
            xt = x.flatten(2).transpose(1, 2).reshape(B * area, n // area, C)
            o, v = area_attention_qkv_fused(xt.contiguous(), w, b,
                                            self.num_heads)

        def spatial(t):
            return t.reshape(B, H, W, C).permute(0, 3, 1, 2)

        return self.proj(spatial(o) + self.pe(spatial(v)))


class ABlock(nn.Module):
    """x + attn(x); x + mlp(x), mlp_ratio 2."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 2.0,
                 area: int = 1):
        super().__init__()
        self.attn = AAttn(dim, num_heads, area)
        h = int(dim * mlp_ratio)
        self.mlp = nn.Sequential(Conv(dim, h, 1), Conv(h, dim, 1, act=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(x)
        return x + self.mlp(x)


class A2C2f(nn.Module):
    """Area-attention C2f: cv1 -> n stages of (2x ABlock | C3k) -> concat ->
    cv2. a2=True uses attention stages (backbone), a2=False C3k (neck).
    `mega_kernel` (off by default) routes an attention block at eval through
    the whole-block kernel where its shape is eligible; training mode and
    every other shape run the staged modules."""

    def __init__(self, c1: int, c2: int, n: int = 1, a2: bool = True,
                 area: int = 1, mlp_ratio: float = 2.0, e: float = 0.5,
                 g: int = 1, shortcut: bool = True,
                 mega_kernel: bool = False):
        super().__init__()
        c_ = int(c2 * e)
        num_heads = max(1, c_ // 32)
        self.a2, self.area, self.num_heads = a2, area, num_heads
        self.mega_kernel = mega_kernel
        self._folded = None       # (key, weights) of the last folding
        self.cv1 = Conv(c1, c_, 1, 1)
        self.cv2 = Conv((1 + n) * c_, c2, 1)
        self.m = nn.ModuleList(
            nn.Sequential(*(ABlock(c_, num_heads, mlp_ratio, area)
                            for _ in range(2))) if a2
            else C3k(c_, c_, 2, shortcut, g)
            for _ in range(n))

    def folded_weights(self, dtype: torch.dtype):
        """The block's flat weight list for `a2c2f_fused`: GEMM weights
        (cin, cout) in `dtype`, biases and the (7, 7, c_) pe kernels f32.
        Folded once and kept until a parameter or buffer of the block is
        written (its version counter moves) or replaced (`.to(device)`), so
        that a served block is one kernel launch and not ~200 small ones."""
        key = (dtype, *((t.data_ptr(), t._version) for t in
                        itertools.chain(self.parameters(), self.buffers())))
        if self._folded is None or self._folded[0] != key:
            with torch.no_grad():
                self._folded = (key, self._fold(dtype))
        return self._folded[1]

    def _fold(self, dtype: torch.dtype):
        def gemm(conv: Conv):
            w, b = conv.folded()
            return [w[:, :, 0, 0].t().contiguous().to(dtype), b.contiguous()]

        ws = gemm(self.cv1)
        for stage in self.m:
            for blk in stage:
                wpe, bpe = blk.attn.pe.folded()
                ws += [*blk.attn.folded_qkv(dtype),
                       wpe[:, 0].permute(1, 2, 0).contiguous(),
                       bpe.contiguous(), *gemm(blk.attn.proj),
                       *gemm(blk.mlp[0]), *gemm(blk.mlp[1])]
        return ws + gemm(self.cv2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mega_kernel and self.a2 and not self.training:
            B, cin, H, W = x.shape
            area = self.area if (H * W) % self.area == 0 else 1
            c_ = self.cv1.conv.out_channels
            if a2c2f_mega_eligible(H, W, cin, c_, area, self.num_heads):
                out = a2c2f_fused(x.permute(0, 2, 3, 1).contiguous(),
                                  self.folded_weights(x.dtype), len(self.m),
                                  area, self.num_heads)
                return out.permute(0, 3, 1, 2)
        y = [self.cv1(x)]
        y.extend(m(y[-1]) for m in self.m)
        return self.cv2(torch.cat(y, 1))
