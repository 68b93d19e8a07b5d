"""Whole-A2C2f block kernel (CUDA, sm_90a). Sources: `../csrc/a2c2f.cuh`
(what both types share, the C entry), `../csrc/a2c2f_f32.cu` and
`../csrc/a2c2f_bf16.cu`.

`a2c2f_fused` runs a full A2C2f attention block at eval (BatchNorm folded
into affine GEMMs) in one launch: cv1 -> n stages of two ABlocks (qkv, band
attention, depthwise 7x7 positional term, projection, MLP, residuals) -> cv2
over the concatenated stage outputs. Replaces the TPU kernel
`yolou_tpu/ops/pallas_a2c2f.py::a2c2f_fused` (body `_a2c2f_kernel`). The
MLP's hidden width is the one its weights give (mlp_ratio * c_); the bf16
kernel takes it padded to a multiple of 16 (`A2C2f.folded_weights` pads)
and keeps h in shared memory where it fits, else in a (tokens, hid) scratch
the wrapper allocates (`bf16_plan`'s `h_tile`), so any width runs.
The residual-gamma form of A2C2f does not route here in either package. The
entry point is the `torch.library` operator `yolou::a2c2f` behind a checking
wrapper, as in `attention.py`.

Any head width and any number of stages: heads whose width is not 32 or 64
are padded with zero channels to the next of the two, or past 64 to the
next multiple of 64 (`attention.padded_head_dim`; `pad_a2c2f_heads`: the
qkv columns per role and head, the pe taps and bias, the proj rows;
`A2C2f.folded_weights` pads once, the wrapper pads what it is given
unpadded), and the kernel takes the true scale. Heads wider than 64 run in
both kernels' blocked form: a (head, 64-channel output block) pair at a
time, its scores summed over the head's 64-channel blocks, in the shared
memory of a head of 64. The ABlocks' weight
pointers reach the kernel as a device array, so the stage count is free.
The f32 kernel takes widths (cin, c_, MLP, c2) that are multiples of 4, the
bf16 one multiples of 8; the wrapper pads others with zeros
(`pad_f32_widths`, kept per weight list), as exact as the MLP's padding. It
packs every GEMM weight once for the kernel's bulk copies (f32:
`pack_f32_weight`, bf16: `pack_bf16_weight`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import build
from .attention import (_DTYPE_CODE, _SMEM_LIMIT, _SMS, HEAD_DIM,
                        _check_aligned, pad_heads, padded_head_dim)

# a2c2f_f32.cu's kernel: token tiles (TM), largest first; its threads; K
# rows of a GEMM stage and the ring's stages; keys of an attention tile, its
# stages, and the probabilities' row stride (floats)
F32_TILES = (64, 32)
_F32_THREADS = 256
_KS, _STAGES = 32, 4
_KB_ATT, _ATT_STAGES, _LDP_ATT = 64, 2, 76
_PER_BLOCK = 10    # tensors per ABlock in the flat weight list
# a2c2f_bf16.cu's kernel: rows of a wgmma tile, columns of a swizzled block,
# of a GEMM panel, weight ring stages at most, keys of a k/v tile, the
# positional term's row (floats), rows of a stencil box at most, channels of
# a stencil block, mbarriers, a staged accumulator's row (floats), a k/v
# ring's stages, and the dynamic shared memory it may take
_ROWS, _KBLK, _PANEL, _MAX_RING = 64, 64, 128, 4
_KV_KEYS, _PE_LD, _VB_MAX, _CBLK, _N_BARS = 128, 72, 256, 64, 29
_KV_STAGES = 2
_STAGE_LD = 136
_BF16_SMEM_LIMIT = 227 * 1024 - 1024


def a2c2f_mega_eligible(H: int, W: int, cin: int, c_: int, area: int,
                        heads: int) -> bool:
    """Static gate for routing A2C2f's eval path through `a2c2f_fused`; the
    same answers as the JAX package's gate, so both packages route alike:
    band length a multiple of 16, 640-class shapes only (at least 400
    tokens), N * c_ <= 1600 * 64 and cin <= 512."""
    n = H * W
    if n % area:
        area = 1
    nb = n // area
    return (nb % 16 == 0 and c_ % heads == 0 and n >= 400
            and n * c_ <= 1600 * 64 and cin <= 512)


def _split(weights: Sequence[torch.Tensor], n_stages: int):
    """(cv1, [ABlock tensors] * 2 n_stages, cv2) from the flat list."""
    ws = list(weights)
    blocks = [ws[2 + _PER_BLOCK * a: 2 + _PER_BLOCK * (a + 1)]
              for a in range(2 * n_stages)]
    return ws[:2], blocks, ws[-2:]


def band_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         dtype: torch.dtype,
                         scale: float | None = None) -> torch.Tensor:
    """softmax(q k^T * scale) v over (G, heads, nb, hd) f32 tensors that
    hold `dtype` values (scale hd ** -0.5 unless given: a padded head keeps
    its true one): the row maximum subtracted, the unnormalised exp rounded
    to `dtype` before p.v, the division by the f32 sum of the unrounded exp
    after it. Returns f32."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    return torch.matmul(e.to(dtype).float(), v) / e.sum(-1, keepdim=True)


def a2c2f_fused_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                      n_stages: int, area: int, heads: int,
                      attention=band_attention_plain) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: every GEMM
    accumulates in f32 and adds its f32 bias; y0, qkv, (o + pe), h and each t
    are rounded to x.dtype; residual adds are in f32; the attention is
    `attention(q, k, v, x.dtype)` per band and head (`band_attention_plain`;
    a test may pass an emulation of the kernel's blocking), its f32 output
    added to the f32 positional term before the rounding. The weights may
    carry heads padded to a kernel width (`pad_a2c2f_heads`): the attention
    is then `ca` = qkv's width / 3 channels wide and keeps the true scale
    (c_ / heads) ** -0.5, passed as `scale=`."""
    B, H, W, cin = x.shape
    (wcv1, bcv1), blocks, (wcv2, bcv2) = _split(weights, n_stages)
    c_ = wcv1.shape[1]
    ca = blocks[0][0].shape[1] // 3           # the attention's width
    N, dt, hd = H * W, x.dtype, ca // heads
    nb = N // area
    padded = {} if ca == c_ else {"scale": (c_ // heads) ** -0.5}

    def gemm(t, w, b):
        return torch.matmul(t.float(), w.float()) + b

    def heads_view(a):     # (B, N, ca) -> (B * area, heads, nb, hd) f32
        return a.reshape(B * area, nb, heads, hd).transpose(1, 2).float()

    t = F.silu(gemm(x.reshape(B, N, cin), wcv1, bcv1)).to(dt)
    ys = [t]
    for a, (wqkv, bqkv, wpe, bpe, wproj, bproj, wm1, bm1, wm2,
            bm2) in enumerate(blocks):
        q, k, v = gemm(t, wqkv, bqkv).to(dt).split(ca, -1)
        o = attention(heads_view(q), heads_view(k), heads_view(v), dt,
                      **padded)
        o = o.transpose(1, 2).reshape(B, N, ca)
        pe = F.conv2d(v.reshape(B, H, W, ca).permute(0, 3, 1, 2).float(),
                      wpe.permute(2, 0, 1)[:, None], bpe, padding=3, groups=ca)
        pe = pe.permute(0, 2, 3, 1).reshape(B, N, ca)
        t = (t.float() + gemm((o + pe).to(dt), wproj, bproj)).to(dt)
        h = F.silu(gemm(t, wm1, bm1)).to(dt)
        t = (t.float() + gemm(h, wm2, bm2)).to(dt)
        if a % 2:
            ys.append(t)
    out = F.silu(gemm(torch.cat(ys, -1), wcv2, bcv2)).to(dt)
    return out.reshape(B, H, W, wcv2.shape[1])


def pad_a2c2f_heads(weights: Sequence[torch.Tensor], n_stages: int,
                    heads: int, hdp: int) -> list:
    """The flat weight list with every head padded to hdp channels: per
    ABlock the qkv weight's columns and bias per role and head
    (`attention.pad_heads`), the pe taps and bias per head, the proj
    weight's rows per head; the rest as given. Exact: q and k meet zeros in
    the scores, v's padded channels and their positional term are zero, and
    proj's zero rows drop them."""
    ws = list(weights)
    for a in range(2 * n_stages):
        i = 2 + _PER_BLOCK * a
        wqkv, bqkv, wpe, bpe, wproj = ws[i:i + 5]
        c_ = wqkv.shape[0]
        ws[i] = pad_heads(wqkv.reshape(c_, 3, -1), heads, hdp).reshape(c_, -1)
        ws[i + 1] = pad_heads(bqkv.reshape(3, -1), heads, hdp).reshape(-1)
        ws[i + 2] = pad_heads(wpe, heads, hdp)
        ws[i + 3] = pad_heads(bpe, heads, hdp)
        ws[i + 4] = pad_heads(wproj.t(), heads, hdp).t().contiguous()
    return ws


def _up(k: int, m: int) -> int:
    return -(-k // m) * m


def _up4(k: int) -> int:
    return _up(k, 4)


def pad_f32_widths(x: torch.Tensor, weights: Sequence[torch.Tensor],
                   n_stages: int, mult: int = 4):
    """(x, weights) with cin, c_, the MLP's width and c2 zero-padded to
    multiples of `mult` (4: the f32 kernel's 16-byte rows; 8: the bf16
    kernel's): x's channels and cv1's
    rows; c_ as cv1's columns and bias, the rows of qkv and mlp1, the
    columns and biases of proj and mlp2, and cv2's rows of every ys slot;
    the MLP as mlp1's columns and bias and mlp2's rows; c2 as cv2's columns
    and bias (the caller cuts the output back). Exact: a padded channel of
    the residual stream is silu(0) = 0 after cv1 and stays 0."""
    (wcv1, bcv1), blocks, (wcv2, bcv2) = _split(weights, n_stages)
    cin, c_ = wcv1.shape
    hid, c2 = blocks[0][6].shape[1], wcv2.shape[1]
    dc, dh = _up(c_, mult) - c_, _up(hid, mult) - hid

    def cols(t, n):
        return F.pad(t, (0, n)) if n else t

    def rows(t, n):
        return F.pad(t, (0, 0, 0, n)) if n else t

    ws = [rows(cols(wcv1, dc), _up(cin, mult) - cin), cols(bcv1, dc)]
    for wqkv, bqkv, wpe, bpe, wproj, bproj, wm1, bm1, wm2, bm2 in blocks:
        ws += [rows(wqkv, dc), bqkv, wpe, bpe, cols(wproj, dc),
               cols(bproj, dc), rows(cols(wm1, dh), dc), cols(bm1, dh),
               cols(rows(wm2, dh), dc), cols(bm2, dc)]
    wcv2 = wcv2.reshape(n_stages + 1, c_, c2)
    wcv2 = F.pad(wcv2, (0, _up(c2, mult) - c2, 0, dc)).reshape(
        -1, _up(c2, mult))
    ws += [wcv2, cols(bcv2, _up(c2, mult) - c2)]
    return (cols(x, _up(cin, mult) - cin).contiguous(),
            [w.contiguous() for w in ws])


def f32_panel(tile: int) -> int:
    """The f32 kernel's GEMM panel (columns) at token tile `tile`: 4
    columns a thread of 256 over tile / 4 row groups."""
    return 4 * _F32_THREADS // (tile // 4)


def f32_smem_bytes(tile: int, hd: int = HEAD_DIM) -> int:
    """One CTA's shared memory in the f32 kernel (a2c2f_f32.cu's
    `F32Layout`) at token tile `tile` and head width `hd`: 1024 bytes of
    alignment
    slack, the larger of the GEMM ring (4 stages of a [tile][32] activation
    slab and a [32][4096 / tile] weight slab) and the attention's (2 stages
    of 64 / tile key groups' k and v tiles of 64 x hd, the q rows in rows of
    hd + 4 and each key group's probability rows; heads wider than 64, the
    blocked form: 2 stages of the key groups' k and v tiles of 64 x 64 and
    q's 64-channel block of the tile's rows), then 10 mbarriers. It
    depends on no width of the block and on no stage count."""
    gemm = _STAGES * (tile * _KS + _KS * f32_panel(tile))
    groups = 64 // tile               # key groups, each its own p rows
    if hd > 64:
        att = (_ATT_STAGES * (2 * groups * _KB_ATT + tile) * 64
               + groups * tile * _LDP_ATT)
    else:
        att = (_ATT_STAGES * 2 * groups * _KB_ATT * hd + tile * (hd + 4)
               + groups * tile * _LDP_ATT)
    return 1024 + 4 * max(gemm, att) + 8 * (2 * _STAGES + _ATT_STAGES)


def f32_tile(batch: int, nb: int, area: int) -> int:
    """The token tile of both kernels for `batch` images of `area` bands
    of nb tokens: of `F32_TILES`, the one whose grid puts the fewest token
    rows on the busiest of an H100's SMs (tiles spread over the SMs first),
    the larger on a tie (half the weight traffic a token)."""
    def rows(tile):
        return -(-batch * area * -(-nb // tile) // _SMS) * tile
    return min(F32_TILES, key=lambda t: (rows(t), -t))


def bf16_stencil_boxes(width: int) -> tuple:
    """(rows a box, boxes) of the bf16 kernel's stencil rows for images
    `width` tokens wide: a 64-token tile +- 3 image rows and 3 tokens, 6
    width + 70 rows, in the fewest boxes of at most 256 rows (a multiple of
    8 each)."""
    need = _ROWS + 6 * width + 6
    boxes = -(-need // _VB_MAX)
    return _up(-(-need // boxes), 8), boxes


def bf16_layout(c_: int, ca: int, hid: int, hd: int, ring: int,
                width: int, staged: bool = True, h_tile: bool = True) -> int:
    """Bytes of the bf16 kernel's dynamic shared memory (a2c2f_bf16.cu's
    `layout`) at weight ring stages `ring`: the ring (16 KB a stage), the t
    (c_) and u (ca) tiles (8 KB a 64-column block), then the largest of the
    attention's buffers (two q tiles and a k/v ring of 2 stages of 128
    keys for each of the two heads of 32 the consumer warpgroups take at
    once, or for the one head of 64, or for the 64-channel blocks of a
    head wider than 64 (the blocked form); the stencil's v rows for images
    `width` tokens wide unless not `staged` (the stencil then reads through
    L2), the f32 positional term) and the GEMMs' (the h tile, unless not
    `h_tile` (h then lives in global memory), or the ring's x / ys / h
    boxes, 8 KB a stage, then the f32 accumulator's staging); the
    mbarriers and 1024 bytes of alignment slack."""
    vb, boxes = bf16_stencil_boxes(width) if staged else (0, 0)
    hd = 32 if hd == 32 else 64       # heads past 64: blocks of 64
    rings = 1 if hd == 64 else 2      # k/v rings, one a consumer warpgroup
    attention = (rings * 2 * _ROWS * hd * 2
                 + rings * _KV_STAGES * 2 * _KV_KEYS * hd * 2
                 + vb * boxes * _CBLK * 2 + _ROWS * _PE_LD * 4)
    h = _up(hid, 64) * _ROWS * 2 if h_tile else 0
    gemms = max(h, ring * _ROWS * _KBLK * 2) + _ROWS * _STAGE_LD * 4
    region = max(attention, gemms)
    return (ring * _PANEL * _KBLK * 2 + (_up(c_, 64) + _up(ca, 64)) * _ROWS * 2
            + region + 8 * _N_BARS + 1024)


class Bf16Plan(NamedTuple):
    """The bf16 kernel's shared memory (bytes), weight ring stages, whether
    the stencil's v rows are staged, and whether h is a tile in shared
    memory (else in a (tokens, hid) scratch in global memory)."""
    bytes: int
    ring: int
    staged: bool
    h_tile: bool


def bf16_plan(c_: int, ca: int, hid: int, hd: int,
              width: int) -> Bf16Plan | None:
    """The bf16 kernel's plan for images `width` tokens wide (a2c2f_bf16.cu's
    `plan`): the largest weight ring of 4, 3 or 2 stages that fits a block
    with the stencil's v rows staged; where none does, the largest without
    them (staged False: the stencil reads through L2); where neither fits
    with the h tile (wide MLPs), the same with h in global memory (h_tile
    False). Widths as the kernel takes them (c_ a multiple of 8, hid of
    16)."""
    for h_tile in (True, False):
        for staged in (True, False):
            for ring in range(_MAX_RING, 1, -1):
                nbytes = bf16_layout(c_, ca, hid, hd, ring, width, staged,
                                     h_tile)
                if nbytes <= _BF16_SMEM_LIMIT:
                    return Bf16Plan(nbytes, ring, staged, h_tile)
    return None


def _check(x, weights, n_stages, area, heads):
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, cin), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if n_stages < 1 or len(weights) != 4 + 2 * _PER_BLOCK * n_stages:
        raise ValueError(f"{len(weights)} weight tensors do not make "
                         f"n_stages={n_stages} (want 4 + 20 * n_stages)")
    B, H, W, cin = x.shape
    if B < 1 or H * W < 1 or area < 1 or (H * W) % area:
        raise ValueError(f"H*W={H * W} tokens of B={B} images do not split "
                         f"into area={area} bands")
    if weights[0].dim() != 2:
        raise ValueError("cv1's weight must be a (cin, c_) matrix")
    c_ = weights[0].shape[1]
    if heads <= 0 or c_ % heads:
        raise ValueError(f"c_={c_} is not a multiple of heads={heads}")
    (wcv1, bcv1), blocks, (wcv2, bcv2) = _split(weights, n_stages)
    # the attention's width: c_, or heads padded to a kernel width
    ca = blocks[0][0].shape[-1] // 3 if blocks[0][0].dim() == 2 else c_
    if ca != c_ and ca != heads * padded_head_dim(c_ // heads):
        raise ValueError(f"qkv's width {3 * ca} is neither 3 c_ = {3 * c_} "
                         f"nor heads padded to a kernel width")
    gemms = [("cv1", wcv1, bcv1, cin, c_)]
    f32 = [bcv1, bcv2]
    hid = blocks[0][6].shape[-1]      # the MLP's width, from mlp1's weight
    for a, (wqkv, bqkv, wpe, bpe, wproj, bproj, wm1, bm1, wm2,
            bm2) in enumerate(blocks):
        gemms += [(f"qkv{a}", wqkv, bqkv, c_, 3 * ca),
                  (f"proj{a}", wproj, bproj, ca, c_),
                  (f"mlp1_{a}", wm1, bm1, c_, hid),
                  (f"mlp2_{a}", wm2, bm2, hid, c_)]
        if tuple(wpe.shape) != (7, 7, ca) or bpe.numel() != ca:
            raise ValueError(f"pe{a}: weight {tuple(wpe.shape)} / bias "
                             f"{tuple(bpe.shape)}, want (7, 7, {ca}) / {ca}")
        f32 += [bqkv, wpe, bpe, bproj, bm1, bm2]
    if wcv2.dim() != 2:
        raise ValueError("cv2's weight must be a matrix")
    gemms.append(("cv2", wcv2, bcv2, (n_stages + 1) * c_, wcv2.shape[1]))
    for name, w, b, k, n in gemms:
        if tuple(w.shape) != (k, n) or b.numel() != n:
            raise ValueError(f"{name}: weight {tuple(w.shape)} / bias "
                             f"{tuple(b.shape)}, want ({k}, {n}) / {n}")
        if w.dtype != x.dtype:
            raise TypeError(f"{name}: weight is {w.dtype}, x is {x.dtype}")
    if any(t.dtype != torch.float32 for t in f32):
        raise TypeError("biases and the pe kernels must be float32")
    if not (x.is_contiguous() and all(w.is_contiguous() for w in weights)):
        raise ValueError("x and the weights must be contiguous")
    if any(w.device != x.device for w in weights):
        raise ValueError("x and the weights must be on one device")
    return c_, wcv2.shape[1]


_CACHE_SIZE = 4
_prepared: dict = {}     # the kernel's weight lists and block arrays, kept


def _kept(key, make, keep=()):
    """`make()` kept under `key` (a few entries, oldest dropped) with the
    tensors `keep` (the ones the key names by pointer: alive, their memory
    cannot come back under another tensor): the padded weight lists and the
    device arrays of block pointers that a served module asks for on every
    call."""
    if key not in _prepared:
        if len(_prepared) >= _CACHE_SIZE:
            _prepared.pop(next(iter(_prepared)))
        _prepared[key] = (tuple(keep), make())
    return _prepared[key][1]


_GEMM_SLOTS = (0, -2)        # cv1, cv2 in the flat list; then per ABlock
_BLOCK_GEMMS = (0, 4, 6, 8)  # qkv, proj, mlp1, mlp2


def pack_f32_weight(w: torch.Tensor, panel: int) -> torch.Tensor:
    """A (K, N) GEMM weight as the f32 kernel streams it: [ceil(N / panel)]
    [ceil32(K)][panel], zero past K and N, so that each stage's slab of 32
    rows x `panel` columns is one contiguous bulk copy."""
    k, n = w.shape
    kp, panels = -(-k // _KS) * _KS, -(-n // panel)
    w = F.pad(w, (0, panels * panel - n, 0, kp - k))
    return w.reshape(kp, panels, panel).transpose(0, 1).contiguous()


def bf16_panels(n: int) -> list:
    """The output panels of an n-column GEMM in the bf16 kernel: 128
    columns each."""
    return [_PANEL] * -(-n // _PANEL)


def _swizzle128(t: torch.Tensor) -> torch.Tensor:
    """[..., rows, 64] bf16 with each row's 16-byte chunk c moved to c ^
    (row % 8), the 128-byte swizzle TMA and wgmma read (its own inverse)."""
    rows = t.shape[-2]
    idx = (torch.arange(8, device=t.device)[None, :]
           ^ (torch.arange(rows, device=t.device)[:, None] % 8))
    chunks = t.reshape(*t.shape[:-1], 8, 8)
    idx = idx[..., None].expand(rows, 8, 8).expand(chunks.shape)
    return chunks.gather(-2, idx).reshape(t.shape)


def pack_bf16_weight(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) GEMM weight as the bf16 kernel streams it, 1-D: per output
    panel of 128 columns (`bf16_panels`) and per 64-row block of K, the
    [128][64] slab of w^T (K-major, zero past K and N) in the 128-byte
    swizzle, so that each weight stage is one contiguous bulk copy the wgmma
    descriptor reads as it lands. Stage (p, kb) starts at (p * ceil(K / 64)
    + kb) * 128 * 64."""
    k, n = w.shape
    kp, n0, out = _up(k, 64), 0, []
    for width in bf16_panels(n):
        slab = w.new_zeros((width, kp))
        m = min(width, n - n0)
        slab[:m, :k] = w[:, n0:n0 + m].t()
        slab = slab.reshape(width, kp // 64, 64).transpose(0, 1)
        out.append(_swizzle128(slab).reshape(-1))
        n0 += width
    return torch.cat(out)


def unpack_bf16_weight(packed: torch.Tensor, k: int, n: int) -> torch.Tensor:
    """The (K, N) weight back from `pack_bf16_weight`'s form, and the
    padding (the panels' columns past N, the rows past K): (w, padding)."""
    kp, at, cols = _up(k, 64), 0, []
    for width in bf16_panels(n):
        slab = packed[at:at + width * kp].reshape(kp // 64, width, 64)
        cols.append(_swizzle128(slab).transpose(0, 1).reshape(width, kp))
        at += width * kp
    full = torch.cat(cols).t()                  # (kp, sum of widths)
    pad = torch.cat([full[k:].reshape(-1), full[:k, n:].reshape(-1)])
    return full[:k, :n], pad


def _kernel_weights(x, weights, n_stages, heads, tile=0):
    """The weight list as the kernel takes it: heads padded to a kernel
    width (`pad_a2c2f_heads`) unless they are one (or the list is padded
    already), every width a multiple of 4 (f32) or 8 (bf16,
    `pad_f32_widths`) and every GEMM weight packed (f32 for token tile
    `tile`, `pack_f32_weight`; bf16 `pack_bf16_weight`). Kept per list (by
    each tensor's pointer, version and shape), so a served block pads and
    packs once. Returns (x, weights, dims): x
    padded with the weights, dims the kernel's (cin, c_, ca, hid, c2, hd)."""
    c_ = weights[0].shape[1]
    hd = c_ // heads
    ca = weights[2].shape[1] // 3
    hdp = ca // heads if ca != c_ else padded_head_dim(hd)
    f32 = x.dtype == torch.float32
    mult = 4 if f32 else 8
    dims = (_up(x.shape[-1], mult), _up(c_, mult), heads * hdp,
            _up(weights[8].shape[1], mult), _up(weights[-2].shape[1], mult),
            hdp)
    key = ("weights", x.dtype, n_stages, heads, tile,
           *((t.data_ptr(), t._version, tuple(t.shape)) for t in weights))

    def make():
        ws = list(weights)
        if ca == c_ and hdp != hd:
            ws = pad_a2c2f_heads(ws, n_stages, heads, hdp)
        ws = pad_f32_widths(x[:0], ws, n_stages, mult)[1]
        gemms = [*_GEMM_SLOTS] + [2 + _PER_BLOCK * a + i
                                  for a in range(2 * n_stages)
                                  for i in _BLOCK_GEMMS]
        for i in gemms:
            ws[i] = (pack_f32_weight(ws[i], f32_panel(tile)) if f32
                     else pack_bf16_weight(ws[i]))
        return ws

    ws = _kept(key, make, weights)
    if dims[0] != x.shape[-1] or x.data_ptr() % 16:
        x = F.pad(x, (0, dims[0] - x.shape[-1])).contiguous()
    return x, ws, dims


def _launch_a2c2f(x, weights, n_stages, area, heads, tile=None):
    """Launch the whole-block kernel on checked CUDA tensors at token tile
    `tile` in place of `f32_tile`'s (for comparisons); returns out."""
    lib = build.load()                # before any pointer is read
    B, H, W, _ = x.shape
    c2_out = weights[-2].shape[1]
    scale = (weights[0].shape[1] // heads) ** -0.5
    nb = H * W // area
    f32 = x.dtype == torch.float32
    tile = tile or f32_tile(B, nb, area)
    if not f32 and weights[8].shape[1] % 16:
        raise ValueError(f"the bf16 kernel needs the MLP width padded to a "
                         f"multiple of 16 (A2C2f.folded_weights pads it), "
                         f"got {weights[8].shape[1]}")
    x, weights, (cin, c_, ca, hid, c2, hd) = _kernel_weights(
        x, weights, n_stages, heads, tile)
    tokens = B * H * W
    work = None       # f32: the t1 | h | u scratch; bf16: h, if not a tile
    if f32:
        work = torch.empty((tokens, c_ + hid + ca), dtype=torch.float32,
                           device=x.device)
    else:
        plan = bf16_plan(c_, ca, hid, hd, W)
        if plan is None:
            raise ValueError(f"c_={c_}, MLP {hid}, heads of {hd} pass a "
                             f"block's shared memory")
        if not plan.h_tile:
            work = torch.empty((tokens, hid), dtype=x.dtype, device=x.device)
        # the stencil reads its taps 16 B a time
        _check_aligned(*(blk[2] for blk in _split(weights, n_stages)[1]))
    out = torch.empty((B, H, W, c2), dtype=x.dtype, device=x.device)
    ys = torch.empty((tokens, (n_stages + 1) * c_), dtype=x.dtype,
                     device=x.device)
    qkv = torch.empty((2, tokens, 3 * ca), dtype=x.dtype, device=x.device)
    ptrs = [w.data_ptr() for w in weights]
    blocks = _kept(("blocks", x.device, *ptrs[2:-2]), lambda: torch.tensor(
        ptrs[2:-2], dtype=torch.int64).to(x.device))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.yolou_a2c2f(x.data_ptr(),
                               (ctypes.c_void_p * len(ptrs))(*ptrs),
                               len(ptrs), out.data_ptr(), ys.data_ptr(),
                               qkv.data_ptr(), B, H, W, cin, c_, c2, hid,
                               n_stages, area, heads, _DTYPE_CODE[x.dtype],
                               blocks.data_ptr(),
                               None if work is None else work.data_ptr(),
                               ca, scale,
                               tile, stream)
    build.check(lib, code, "A2C2f block kernel")
    a2c2f_fused.launches += 1
    return out if c2 == c2_out else out[..., :c2_out].contiguous()


def _a2c2f_forward(x, weights, n_stages, area, heads):
    """The whole-block kernel on a CUDA tensor, the plain version on a CPU
    tensor: the real version of the operator (which has no autograd)."""
    if x.device.type == "cpu":
        return a2c2f_fused_plain(x, weights, n_stages, area, heads)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _launch_a2c2f(x, weights, n_stages, area, heads)


a2c2f_op = torch.library.custom_op(
    "yolou::a2c2f", _a2c2f_forward, mutates_args=(),
    schema="(Tensor x, Tensor[] weights, int n_stages, int area, int heads)"
           " -> Tensor")


@a2c2f_op.register_fake
def _(x, weights, n_stages, area, heads):
    return x.new_empty((*x.shape[:3], weights[-2].shape[1]))


def a2c2f_fused(x: torch.Tensor, weights: Sequence[torch.Tensor],
                n_stages: int, area: int, heads: int) -> torch.Tensor:
    """Run a full A2C2f attention block (eval, BatchNorm folded) in one
    kernel launch.

    x: (B, H, W, cin) channels last, float32 or bfloat16. weights: flat list
    [cv1_w, cv1_b] + per ABlock [qkv_w, qkv_b, pe_w (7,7,c_), pe_b, proj_w,
    proj_b, mlp1_w, mlp1_b, mlp2_w, mlp2_b] * (2 * n_stages) + [cv2_w,
    cv2_b]; GEMM weights are (cin_i, cout_i) matrices in x.dtype (qkv's
    output role-major q | k | v, each third head-major), biases and the pe
    kernels float32. Returns (B, H, W, c2) in x.dtype. Not differentiable,
    as its JAX counterpart defines no VJP: it raises on either device when
    grad mode is on and x or a weight requires grad.
    """
    _check(x, weights, n_stages, area, heads)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (x, *weights)):
        raise RuntimeError(
            "a2c2f_fused is not differentiable (an eval-only kernel with no "
            "backward): call it under torch.no_grad() or on tensors that do "
            "not require grad")
    return a2c2f_op(x, list(weights), n_stages, area, heads)


a2c2f_fused.launches = 0
