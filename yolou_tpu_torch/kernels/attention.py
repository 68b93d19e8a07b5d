"""Band attention kernels (CUDA, sm_90a). Sources: `../csrc/band_attention.cu`
(the streamed path) and `../csrc/band_attention_short.cu` (the short path).

Kernel A, `area_attention_qkv_fused`: folded qkv projection + multi-head band
attention, the eval path. Replaces the TPU kernel
`yolou_tpu/ops/pallas_attn.py::area_attention_qkv_fused` (body
`_qkv_attn_kernel`).

Kernel C, `area_attention_fused` and `area_attention`: attention over given
q, k, v, the training path, differentiable. Replaces the TPU kernels
`area_attention_fused` (body `_fused_kernel`) and `area_attention` (body
`_attn_kernel`) of the same file; the second is the first with one head. As
in the JAX package only the forward is a kernel: the backward recomputes the
softmax in f32 with plain tensor operations, term for term what `_aaf_bwd`
and `_aa_bwd` do there.

Kernel A is differentiable too, as its JAX counterpart is (`_aaq_bwd`): the
backward is the plain version's VJP, autograd through
`area_attention_qkv_fused_plain` recomputed from the saved (x, w, b) with the
cotangents of both outputs, the same code on the CPU and the card. Where
grad mode is off or no input requires grad, autograd keeps no record (the
serving path calls it 8 times a forward).

Each entry point is a `torch.library` operator (`yolou::band_attention_qkv`,
`yolou::band_attention`, `yolou::band_attention_single`) behind a Python
wrapper that checks shapes, types and devices. The operator's fake version
gives only its outputs' shapes and types, so `torch.export` records the call
as one graph node; its real version dispatches by device and counts the
launches. Reading pointers (the alignment check, the launch) happens only
in the real version: a traced tensor has none.

Both entry points dispatch by type inside the C library: bfloat16 runs on
the tensor cores, float32 on the FMA units in full f32 (which the 1e-4
comparisons rest on; no TF32). Neither falls back to the other or to the
plain version.

At heads of 64 channels or fewer both kernels take one of two paths, in
both types, chosen by `attention_plan` from the band's length alone (wider
heads take the blocked path, below). Every band of 64 tokens or
fewer runs the short path (`band_attention_short.cu`): one launch attends
a tile of 64 rows holding P = 64 // N whole bands (kernel A also projects
them), scores across two bands of a tile masked, a single-pass softmax
against the full row's maximum (bf16 on wgmma, f32 on FMA micro-tiles in
tiles of 64 or 32 rows, `short_rows`). Longer bands run the streamed path,
which passes keys and values through a ring of shared-memory stages loaded
by TMA (kernel A then in two launches: the k and v projection, k into a
scratch, then the attention): bf16 on `wgmma` with one or two consumer
warpgroups of 64 query rows and 128-key tiles, f32 on 4 x 4 register
micro-tiles in CTAs of 64, 32 or 16 query rows and 64-key tiles
(`stream_rows`). Both paths hold the same numerics contract (f32 scores,
maximum and sum; probabilities rounded to the I/O type before p.v; the
division after it), the short one against the full row's maximum, the
streamed one against a running one: their bf16 results are close, not
bit-identical. No band length is refused, and no width C: where kernel
A's q-projecting streamed kernel would not fit a block (it holds the
head's (C, hd) q weight columns and, in bf16, the CTA's (rows, C) x tile:
bf16 from 928 channels at heads of 32 and 512 at heads of 64, f32 from
1344 and 640), kernel A takes its wide form (`wide_plan`): the projection
launch writes q too, into a scratch, and kernel C's streamed attention
reads q, k and v. Both GEMMs ring over C, so neither launch grows with it.

Head widths. The short and streamed kernels are built for heads 32 and 64
channels wide (`KERNEL_HEAD_DIMS`); heads wider than 64 run in blocks of 64
channels (`BLOCK`). Every other width is held as the next of the two up to
64 and past 64 as the next multiple of 64 (`padded_head_dim`), with zero
channels after the head's, and runs with the true `hd ** -0.5` as its
scale. Zero channels add exact zeros to every score and give zero output
channels, so this changes no value. Kernel C pads inside the kernel
wherever a head's row is a multiple of 16 bytes (`in_kernel_pad`: bf16
widths of a multiple of 8, f32 of 4, such as 16, 48, 96 or 120): its maps
view q, k and v as (G, N, heads, hd), a box as wide as the kernel's head
(or 64-channel block) reads zeros past the head's hd channels, and o's
stores stop at them, so a call is one device kernel and no copy (path
counts "short bf16 padded", ...). Other widths (bf16 heads of 12, say) and
every width in kernel A are padded by one function on both devices
(`pad_heads`; kernel A also pads x's channels and the qkv weight's rows and
columns, `pad_qkv_projection`), and the padded output channels are cut
away (`cut_heads`). On the CPU the plain versions run at the true width. A
head wider than 64, which no yolov12 module builds (A2C2f makes max(1, c_
// 32) heads), takes the blocked path at any N (`blocked_plan`): kernel C's
blocked form (bf16: a CTA a (head, 64-channel output block, query tile)
whose scores sum over the head's blocks, recomputed by each output block;
f32: a thread-block cluster a (head, query tile), a CTA a 64-channel block,
the partial scores summed over the cluster's distributed shared memory, so
the head's scores are computed once, `cluster_shape`); kernel A runs its
wide form's projection, then that attention.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

HEAD_DIM = 32     # YOLOv12's head width, the default
KERNEL_HEAD_DIMS = (32, 64)  # the short and streamed kernels' head widths
BLOCK = 64        # channels of a block of the blocked form (heads past 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_LIMIT = 227 * 1024
# the short path (band_attention_short.cu): a tile's rows, the channels of a
# ring stage and the ring's stages at most
_SHORT_ROWS = 64
_SHORT_KC = 32
_SHORT_STAGES = 4
_SHORT_F32_CTAS = 256   # f32: 32-row tiles below this many 64-row CTAs
# the streamed path (band_attention.cu): keys a tile and stages of its ring,
# bf16 and f32; query rows of a bf16 consumer warpgroup; the f32 CTA's
# choices of query rows; the f32 probability rows' stride (floats)
_STREAM_KEYS = {torch.bfloat16: 128, torch.float32: 64}
_STREAM_STAGES = {torch.bfloat16: 3, torch.float32: 2}
_WG_ROWS = 64
_F32_ROWS = (64, 32, 16)
_LDP = 76
# the bf16 k/v projection (`kv_projection_wgmma_kernel`): tokens a CTA,
# channels a ring stage, its stages at most, and its panel's columns
_KVB_TM = 64
_KVB_KS = 64
_KVB_STAGES = 4
_KVB_COLS = 64
# the f32 one (`kv_projection_f32_kernel`, gemm_f32.cuh's GEMM stream at
# tiles of 64 tokens): its dynamic shared memory, whatever C: 1024 bytes of
# slack, a ring of 4 stages of a [64][32] x slab and a [32][64] weight slab,
# 8 barriers
_KV_F32_SMEM = 1024 + 4 * 4 * (64 * 32 + 32 * 64) + 8 * 2 * 4
# the blocked form (band_attention.cu): its dynamic shared memory, the same
# at every head width, 1024 bytes of slack and a full and an empty barrier
# a stage: bf16 three units of a 64-row q block and a 128-key k block and
# two 128-key v blocks; f32 two units of a 64-key k block and a 32-row q
# block, two 64-key v blocks and the probabilities of 32 rows
_BLOCKED_ROWS = {torch.bfloat16: 64, torch.float32: 32}
# the f32 cluster form: CTAs of a cluster at most (16, past the portable 8),
# the stages of its rings of 64-key k and v blocks
_CLUSTER_MAX = 16
_K_STAGES = 2
_CV_STAGES = 2
_SMS = 132    # streaming multiprocessors of an H100 SXM


def cluster_shape(hdp: int) -> tuple:
    """(cs, groups) of the f32 blocked form at heads of hdp channels (a
    multiple of `BLOCK`): `groups` clusters of cs CTAs a (head, query tile),
    a CTA a 64-channel block; one cluster up to `_CLUSTER_MAX` blocks (hdp
    <= 1024), past it as few as hold the blocks, as even as can be
    (band_attention.cu::cluster_size, cluster_groups)."""
    nbk = hdp // BLOCK
    groups = -(-nbk // _CLUSTER_MAX)
    return -(-nbk // groups), groups


def blocked_smem_bytes(hdp: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of kernel C's blocked form at heads of hdp
    channels (band_attention.cu::blocked_smem), with 1024 bytes of slack
    for the tiles' alignment and 8 a barrier. bf16, the same at every width:
    three units of a 64-row q block and a 128-key k block and two 128-key
    v blocks, a full and an empty barrier a stage. f32 (the cluster form):
    the resident 32-row q blocks of its `groups` (one up to 1024 channels),
    the rings of 64-key k and v blocks, two buffers of a 64-key tile's
    partial scores and the probabilities of 32 rows; a full and an empty
    barrier a stage and q's."""
    if dtype == torch.bfloat16:
        return (1024 + 2 * (3 * (64 + 128) * BLOCK + 2 * 128 * BLOCK)
                + 8 * 2 * (3 + 2))
    rows, keys = _BLOCKED_ROWS[torch.float32], _STREAM_KEYS[torch.float32]
    groups = cluster_shape(hdp)[1]
    stages = _K_STAGES + _CV_STAGES
    return (1024 + 4 * (groups * rows * BLOCK + stages * keys * BLOCK
                        + 2 * rows * keys + rows * _LDP)
            + 8 * (2 * stages + 1))


# at heads up to 1024 channels (one cluster in f32), the same at every width
_BLOCKED_SMEM = {dt: blocked_smem_bytes(2 * BLOCK, dt)
                 for dt in (torch.bfloat16, torch.float32)}


def area_attention_qkv_fused_plain(x: torch.Tensor, w: torch.Tensor,
                                   b: torch.Tensor, heads: int,
                                   scale: float | None = None):
    """Plain PyTorch version, the same math as the JAX package's
    `_qkv_attn_reference` + `area_attention_fused_reference`: qkv = x.w + b
    in f32, rounded to x.dtype; per head softmax(q k^T * scale) in f32
    (scale hd ** -0.5 unless given: a padded head keeps its true one),
    probabilities rounded to x.dtype, p.v accumulated in f32."""
    g, n, c = x.shape
    hd = w.shape[1] // 3 // heads
    scale = hd ** -0.5 if scale is None else scale
    qkv = (torch.matmul(x.float(), w.float()) + b.reshape(-1)).to(x.dtype)
    q, k, v = qkv.split(w.shape[1] // 3, -1)

    def rs(t):   # (g, n, c) -> (g, heads, n, hd), head-major channels
        return t.reshape(g, n, heads, hd).transpose(1, 2).float()

    s = torch.matmul(rs(q), rs(k).transpose(-1, -2)) * scale
    p = s.softmax(-1).to(x.dtype).float()
    o = torch.matmul(p, rs(v)).transpose(1, 2).reshape(g, n, heads * hd)
    return o.to(x.dtype), v.contiguous()


def padded_head_dim(hd: int) -> int:
    """The kernels' head width that holds a head of `hd` channels: the
    smallest of `KERNEL_HEAD_DIMS` at least `hd` wide; past the widest, the
    next multiple of `BLOCK` (the blocked form's)."""
    return next((k for k in KERNEL_HEAD_DIMS if hd <= k),
                -(-hd // BLOCK) * BLOCK)


def pad_heads(t: torch.Tensor, heads: int, hdp: int) -> torch.Tensor:
    """(..., heads * hd) head-major channels -> (..., heads * hdp): each
    head's hd channels, then hdp - hd zeros."""
    hd = t.shape[-1] // heads
    t = t.reshape(*t.shape[:-1], heads, hd)
    return torch.nn.functional.pad(t, (0, hdp - hd)).flatten(-2).contiguous()


def cut_heads(t: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    """The inverse of `pad_heads`: the first hd channels of each head."""
    t = t.reshape(*t.shape[:-1], heads, t.shape[-1] // heads)
    return t[..., :hd].flatten(-2).contiguous()


def pad_qkv_projection(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       heads: int, hdp: int):
    """Kernel A's operands with every head padded to hdp channels: x's C
    channels followed by zeros up to heads * hdp (CA), the (C, 3C) weight's
    rows likewise and each role's columns per head (`pad_heads`), the bias
    per head; returns (x (G, N, CA), w (CA, 3CA), b (3CA,)). The zero rows
    meet the zero channels of x, so q, k and v keep their values in their
    first hd channels of each head and are zero in the rest."""
    c = x.shape[-1]
    ca = heads * hdp
    xp = torch.nn.functional.pad(x, (0, ca - c)).contiguous()
    wp = pad_heads(w.reshape(c, 3, c), heads, hdp).reshape(c, 3 * ca)
    wp = torch.nn.functional.pad(wp, (0, 0, 0, ca - c)).contiguous()
    bp = pad_heads(b.reshape(3, c), heads, hdp).reshape(3 * ca)
    return xp, wp, bp


def stream_smem_bytes(c: int, dtype: torch.dtype, projection: bool = True,
                      rows: int | None = None, hd: int = HEAD_DIM) -> int:
    """The largest dynamic shared memory of a streamed-path launch
    (band_attention.cu), whatever N, with 1024 bytes of slack for the tiles'
    alignment and 8 a barrier: the ring's stages of a key tile's keys and
    values and the CTA's `rows` query rows (the most it may take by
    default). bfloat16: three stages of 128 keys, q (64 rows a consumer
    warpgroup); kernel A also the head's (C, 32) q weight columns and the
    CTA's (rows, C) x tile, and its projection launch its own
    (`kv_projection_smem`). float32: two stages of 64 keys, q and the
    probabilities (`_LDP` floats a row) of `rows` rows; kernel A also the
    head's (C, 32) q weight columns. At head width `hd` (32 or 64) every
    head-wide tile widens with it."""
    keys, stages = _STREAM_KEYS[dtype], _STREAM_STAGES[dtype]
    bars = 8 * (2 * stages + 1)
    if dtype == torch.bfloat16:
        rows = rows or 2 * _WG_ROWS
        tiles = 2 * stages * keys * hd + rows * hd
        if projection:
            tiles += c * hd + rows * c
        attention = 1024 + 2 * tiles + bars
        return max(attention, kv_projection_smem(c) if projection else 0)
    rows = rows or _F32_ROWS[0]
    return (1024 + 4 * (2 * stages * keys * hd
                        + rows * (hd + _LDP)
                        + (c * hd if projection else 0)) + bars)


def kv_projection_smem(c: int) -> int:
    """Dynamic shared memory of the bf16 k/v projection launch at width C
    (bytes, with 1024 of slack for the tiles' alignment and 8 a barrier):
    its ring of up to `_KVB_STAGES` stages of 64 channels (a 64-token x
    slab and the panel's weight columns) and the staged output tile, rows 8
    elements wider."""
    stages = min(-(-c // _KVB_KS), _KVB_STAGES)
    return (1024 + 2 * (stages * _KVB_KS * (_KVB_TM + _KVB_COLS)
                        + _KVB_TM * (_KVB_COLS + 8)) + 8 * stages)


def stream_rows(g: int, n: int, c: int, dtype: torch.dtype,
                projection: bool = True, hd: int = HEAD_DIM) -> int:
    """The query rows of a streamed CTA for G bands of N tokens at width C,
    the fastest on an H100 over every yolov12 band
    (`tools/attention_routes.py`) as a rule of the grid and the width.
    bfloat16: 128 (two consumer warpgroups, one CTA an SM) past 64 tokens
    where kernel A's q weight columns are 384 wide (two warpgroups share
    them) or the grid of 128-row CTAs is 16 deep on each SM, and their
    shared memory fits; else 64 (one warpgroup, two CTAs an SM). float32:
    64 in kernel A at 256 channels and up where the grid of 64-row CTAs is
    8 deep on each SM (fewer CTAs stage the q weight columns); else 32
    where the grid of 32-row CTAs covers half the SMs; else 16. Heads 64
    wide have one form of each kernel: 64 rows in bf16, 32 in f32."""
    if hd != HEAD_DIM:
        return _WG_ROWS if dtype == torch.bfloat16 else _F32_ROWS[1]
    pairs = g * (c // HEAD_DIM)
    if dtype == torch.bfloat16:
        two = (n > _WG_ROWS
               and ((projection and c >= 384)
                    or pairs * -(-n // (2 * _WG_ROWS)) >= 16 * _SMS)
               and stream_smem_bytes(c, dtype, projection,
                                     2 * _WG_ROWS) <= _SMEM_LIMIT)
        return 2 * _WG_ROWS if two else _WG_ROWS
    if projection and c >= 256 and pairs * -(-n // 64) >= 8 * _SMS:
        return 64
    return 32 if pairs * -(-n // 32) >= _SMS // 2 else 16


# "wide": kernel A only; "blocked": heads wider than 64, both kernels
PATHS = ("short", "streamed", "wide", "blocked")


class AttentionPlan(NamedTuple):
    """How a band runs: its `path` (one of `PATHS`), the largest dynamic
    shared memory of its launches (bytes; the streamed path's: of its
    attention launch, and the bf16 projection's), its device kernels a call,
    and the query rows of a streamed CTA or a short tile (`stream_rows`,
    `short_rows`)."""
    path: str
    smem: int
    launches: int
    rows: int

    @property
    def streamed(self) -> bool:
        """Keys and values streamed through a ring (the streamed path,
        kernel A's wide form or the blocked path; two device kernels in
        kernel A)."""
        return self.path in ("streamed", "wide", "blocked")


def short_smem_bytes(c: int, dtype: torch.dtype, hd: int = HEAD_DIM,
                     rows: int = _SHORT_ROWS, projection: bool = True) -> int:
    """One CTA's dynamic shared memory on the short path
    (band_attention_short.cu::short_smem) at tiles of `rows`, with 1024
    bytes of slack for the tiles' alignment and 8 a barrier. Kernel A
    (`projection`): a ring of min(4, C / 32) stages, each x's [rows][32]
    slab and the head's three [32][hd] weight columns; bf16 also the k and
    v tiles [rows][hd], f32 over the ring's space q, k, v [rows][hd] and
    the probabilities [rows][`_LDP`]. Kernel C: the q, k and v tiles and,
    in f32, the probabilities, one barrier."""
    stages = min(_SHORT_STAGES, c // _SHORT_KC) if projection else 1
    head = rows * hd
    lead = stages * (rows * _SHORT_KC + 3 * _SHORT_KC * hd) if projection \
        else head
    if dtype == torch.bfloat16:
        return 1024 + 2 * (lead + 2 * head) + 8 * stages
    attention = 3 * head + rows * _LDP
    return 1024 + 4 * max(lead if projection else 0, attention) + 8 * stages


def short_rows(g: int, n: int, c: int, dtype: torch.dtype,
               hd: int = HEAD_DIM, projection: bool = True) -> int:
    """The rows of a short-path tile (whole bands, P = rows // N of them):
    bfloat16 64 (a wgmma block); float32 32 where N <= 32 in kernel C (the
    faster at every yolov12 band of 25 tokens on an H100, by 1.25-1.61x;
    `tools/attention_routes.py --kernels C`), and in kernel A
    (`projection`) where a grid of 64-row tiles, a CTA per (tile, head),
    has fewer than `_SHORT_F32_CTAS` CTAs, or at any grid at C = 64 (twice
    the CTAs at the same padding), else 64: within 1 % of the faster of the
    two on an H100 at every yolov12 band of 25 tokens but (512, 25, 128)
    h4, 4.7 % slower (`tools/attention_routes.py --kernels A`)."""
    if dtype == torch.bfloat16 or n > _SHORT_ROWS // 2:
        return _SHORT_ROWS
    if not projection:
        return _SHORT_ROWS // 2
    ctas = -(-g // (_SHORT_ROWS // n)) * (c // hd)
    small = ctas < _SHORT_F32_CTAS or c <= 2 * HEAD_DIM
    return _SHORT_ROWS // 2 if small else _SHORT_ROWS


def short_plan(g: int, n: int, c: int, dtype: torch.dtype,
               hd: int = HEAD_DIM, projection: bool = True) -> AttentionPlan:
    """The short path of kernel A (`projection`) or C: one launch,
    `short_rows` rows a tile."""
    rows = short_rows(g, n, c, dtype, hd, projection)
    return AttentionPlan("short",
                         short_smem_bytes(c, dtype, hd, rows, projection), 1,
                         rows)


def attention_plan(g: int, n: int, c: int, dtype: torch.dtype,
                   projection: bool = True,
                   hd: int = HEAD_DIM) -> AttentionPlan:
    """The path of G bands of N tokens at width C in heads of `hd` (a
    kernel width, 32, 64 or a multiple of 64), kernel A (`projection`) or
    C, in either type: heads wider than 64 the blocked path at any N
    (`blocked_plan`); else the short path at 64 tokens or fewer
    (`short_plan`), else the streamed path (`streamed_plan`)."""
    if hd > BLOCK:
        return blocked_plan(c, dtype, projection, hd)
    if n <= _SHORT_ROWS:
        return short_plan(g, n, c, dtype, hd, projection)
    return streamed_plan(g, n, c, dtype, projection, hd)


def streamed_plan(g: int, n: int, c: int, dtype: torch.dtype,
                  projection: bool = True,
                  hd: int = HEAD_DIM) -> AttentionPlan:
    """The streamed path's plan of G bands of N tokens at width C; kernel
    A's wide form (`wide_plan`) where the q-projecting kernel's shared
    memory passes a block's."""
    rows = stream_rows(g, n, c, dtype, projection, hd)
    smem = stream_smem_bytes(c, dtype, projection, rows, hd)
    if projection and smem > _SMEM_LIMIT:
        return wide_plan(g, n, c, dtype, hd)
    return AttentionPlan("streamed", smem, 2 if projection else 1, rows)


def wide_plan(g: int, n: int, c: int, dtype: torch.dtype,
              hd: int = HEAD_DIM) -> AttentionPlan:
    """Kernel A's wide form at any C: two launches, the projection of q, k
    and v (its shared memory `kv_projection_smem` in bf16, `_KV_F32_SMEM`
    in f32, neither growing with C), then kernel C's streamed attention at
    kernel C's query rows (`stream_rows(..., projection=False)`)."""
    rows = stream_rows(g, n, c, dtype, False, hd)
    return AttentionPlan("wide",
                         max(stream_smem_bytes(c, dtype, False, rows, hd),
                             _projection_smem(c, dtype)), 2, rows)


def _projection_smem(c: int, dtype: torch.dtype) -> int:
    """The projection launch's shared memory at width C (bf16
    `kv_projection_smem`, f32 `_KV_F32_SMEM`)."""
    return kv_projection_smem(c) if dtype == torch.bfloat16 else _KV_F32_SMEM


def blocked_plan(c: int, dtype: torch.dtype, projection: bool,
                 hd: int) -> AttentionPlan:
    """The blocked path of heads of hd channels (a multiple of 64 past 64)
    at width C, any N: kernel C's blocked form, one launch
    (`blocked_smem_bytes`, `_BLOCKED_ROWS` query rows a CTA); kernel A two,
    its wide form's projection of q, k and v first."""
    smem = blocked_smem_bytes(hd, dtype)
    if projection:
        smem = max(smem, _projection_smem(c, dtype))
    return AttentionPlan("blocked", smem, 2 if projection else 1,
                         _BLOCKED_ROWS[dtype])


def _check_aligned(*tensors):
    """The kernels' tensor maps (TMA) and 16-byte loads and stores need
    16-byte aligned bases."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the kernel needs 16-byte aligned tensors")


def _stream_plan(g, n, c, dtype, projection, hd=HEAD_DIM, path="streamed"):
    """The plan of the streamed `path`, of kernel A's wide form by `path`
    "wide" or of the blocked path by "blocked"; the streamed path refused
    where it does not fit a block (kernel A's, forced at a width the plan
    gives the wide form)."""
    if path == "wide":
        return wide_plan(g, n, c, dtype, hd)
    if path == "blocked":
        return blocked_plan(c, dtype, projection, hd)
    plan = streamed_plan(g, n, c, dtype, projection, hd)
    if plan.path != path:
        raise ValueError(f"the streamed kernel needs more shared memory at "
                         f"C={c} than a block has")
    return plan


def _check(x, w, b, heads):
    if x.dim() != 3:
        raise ValueError(f"x must be (G, N, C), got {tuple(x.shape)}")
    g, n, c = x.shape
    if heads <= 0 or c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype} not in {list(_DTYPE_CODE)}")
    if w.dtype != x.dtype or b.dtype != torch.float32:
        raise TypeError(f"w must be {x.dtype} and b float32, got "
                        f"{w.dtype}, {b.dtype}")
    if tuple(w.shape) != (c, 3 * c) or b.numel() != 3 * c:
        raise ValueError(f"w {tuple(w.shape)} / b {tuple(b.shape)} do not "
                         f"match C={c}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("x, w and b must be contiguous")
    if not (x.device == w.device == b.device):
        raise ValueError("x, w and b must be on one device")
    return g, n, c


def in_kernel_pad(hd: int, dtype: torch.dtype) -> bool:
    """Whether kernel C runs heads of hd channels padded inside the kernel
    (one launch, no copy): a width no kernel is built for (not in
    `KERNEL_HEAD_DIMS`, no multiple of `BLOCK`) whose row TMA can address,
    a multiple of 16 bytes: bf16 hd % 8 == 0, f32 hd % 4 == 0
    (hopper.cuh::pads_in_kernel). The others are padded by copies
    (`pad_heads`)."""
    elt = 2 if dtype == torch.bfloat16 else 4
    return (hd > 0 and hd not in KERNEL_HEAD_DIMS and hd % BLOCK != 0
            and hd * elt % 16 == 0)


def _kernel_head_dim(c, heads):
    """The head width of C channels in `heads`, refused on the card unless
    a kernel is built for it (`KERNEL_HEAD_DIMS`, or a multiple of `BLOCK`;
    kernel C's launch takes the widths `in_kernel_pad` admits before this,
    and the wrappers pad the others)."""
    hd = c // heads
    if hd not in KERNEL_HEAD_DIMS and hd % BLOCK:
        raise ValueError(f"the CUDA kernels take head_dim "
                         f"{' or '.join(map(str, KERNEL_HEAD_DIMS))} or a "
                         f"multiple of {BLOCK} (others padded by the "
                         f"wrappers), got {hd}")
    return hd


def _check_path(path, n, projection=True, hd=HEAD_DIM):
    """A forced path: one of `PATHS` (kernel C's: not "wide"), "blocked"
    exactly where heads are wider than 64, the short one at 64 tokens or
    fewer."""
    if path not in PATHS or (path == "wide" and not projection):
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if (path == "blocked") != (hd > BLOCK):
        raise ValueError(f"heads of {hd} channels do not take the {path} "
                         f"path")
    if path == "short" and n > _SHORT_ROWS:
        raise ValueError(f"the short path takes bands of {_SHORT_ROWS} "
                         f"tokens or fewer, got {n}")


def _count_path(wrapper, path, dtype, padded=False):
    """One launch of `wrapper`'s kernel on `path`, by path and type, and
    " padded" where the kernel padded the heads itself (`in_kernel_pad`)."""
    key = f"{path} {'f32' if dtype == torch.float32 else 'bf16'}"
    key += " padded" if padded else ""
    wrapper.path_launches[key] = wrapper.path_launches.get(key, 0) + 1


def _launch_qkv_attention(x, w, b, heads, path=None, rows=None,
                          scale=None):
    """Launch kernel A on checked CUDA tensors whose heads are a kernel width
    (32, 64 or a multiple of 64) on the path `attention_plan` gives (`path`,
    one of `PATHS`, forces one, for comparisons; `rows` the streamed CTA's
    query rows or the short path's tile rows in place of the planned ones);
    `scale` the softmax's (default hd ** -0.5); returns (o, v)."""
    g, n, c = x.shape
    hd = _kernel_head_dim(c, heads)
    if path is None:
        path = attention_plan(g, n, c, x.dtype, hd=hd).path
    _check_path(path, n, hd=hd)
    if path == "short":
        rows = rows or short_rows(g, n, c, x.dtype, hd)
    else:
        rows = rows or _stream_plan(g, n, c, x.dtype, True, hd, path).rows
    lib = build.load()
    _check_aligned(x, w)
    o = torch.empty_like(x)
    v = torch.empty_like(x)
    code = _DTYPE_CODE[x.dtype]
    scale = hd ** -0.5 if scale is None else scale
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
            v.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "streamed":
            k = torch.empty_like(x)      # the projected keys, between launches
            code = lib.yolou_band_attention_qkv_stream(
                *ptrs, k.data_ptr(), g, n, c, heads, code, rows, scale,
                stream)
        elif path in ("wide", "blocked"):   # the projected queries too
            k, q = torch.empty_like(x), torch.empty_like(x)
            code = lib.yolou_band_attention_qkv_wide(
                *ptrs, k.data_ptr(), q.data_ptr(), g, n, c, heads, code,
                rows, scale, stream)
        else:
            code = lib.yolou_band_attention_qkv_short(
                *ptrs, g, n, c, heads, code, rows, scale, stream)
    build.check(lib, code, "band attention kernel")
    area_attention_qkv_fused.launches += 1
    area_attention_qkv_fused.device_launches += 1 if path == "short" else 2
    _count_path(area_attention_qkv_fused, path, x.dtype)
    return o, v


def _qkv_attention_run(x, w, b, heads, scale):
    """Kernel A on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return area_attention_qkv_fused_plain(x, w, b, heads, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"no kernel for device {x.device}")
    return _launch_qkv_attention(x, w, b, heads, scale=scale)


def _qkv_attention_forward(x, w, b, heads):
    """The real version of the operator, on both devices: heads whose width
    is no kernel width are padded (`pad_qkv_projection`, `padded_head_dim`)
    and cut back (`cut_heads`), with the true scale."""
    hd = x.shape[-1] // heads
    hdp = padded_head_dim(hd)
    if hdp == hd:
        return _qkv_attention_run(x, w, b, heads, hd ** -0.5)
    o, v = _qkv_attention_run(*pad_qkv_projection(x, w, b, heads, hdp),
                              heads, hd ** -0.5)
    return cut_heads(o, heads, hd), cut_heads(v, heads, hd)


band_attention_qkv_op = torch.library.custom_op(
    "yolou::band_attention_qkv", _qkv_attention_forward, mutates_args=(),
    schema="(Tensor x, Tensor w, Tensor b, int heads) -> (Tensor, Tensor)")


@band_attention_qkv_op.register_fake
def _(x, w, b, heads):
    return torch.empty_like(x), torch.empty_like(x)


def qkv_attention_backward(x, w, b, do, dv, heads: int):
    """(dx, dw, db) of `area_attention_qkv_fused` for the cotangents `do`
    and `dv` of its two outputs: autograd through the plain version,
    recomputed from (x, w, b), which is what `jax.vjp` of the JAX package's
    `_qkv_attn_reference` computes there."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, w, b)]
        o, v = area_attention_qkv_fused_plain(*inputs, heads)
        return torch.autograd.grad((o, v), inputs, (do, dv))


def _qkv_setup(ctx, inputs, output):
    *tensors, ctx.heads = inputs
    ctx.save_for_backward(*tensors)


def _qkv_backward(ctx, do, dv):
    """On both devices: `qkv_attention_backward`; saves x, w, b only."""
    area_attention_qkv_fused.backward_calls += 1
    return (*qkv_attention_backward(*ctx.saved_tensors, do, dv, ctx.heads),
            None)


band_attention_qkv_op.register_autograd(_qkv_backward,
                                        setup_context=_qkv_setup)


def area_attention_qkv_fused(x: torch.Tensor, w: torch.Tensor,
                             b: torch.Tensor, heads: int):
    """Fused (folded qkv affine) + multi-head band attention.

    x: (G, N, C) band tokens (float32 or bfloat16); w: (C, 3C) BN-folded
    qkv weight in x.dtype with role-major output thirds, each head-major;
    b: (3C,) or (1, 3C) float32 folded bias. Returns (o, v), both (G, N, C)
    in x.dtype: o the attention output, v the value projection (it feeds
    the dw7x7 positional conv). Any N >= 1. Differentiable in x, w and b.
    """
    _check(x, w, b, heads)
    return band_attention_qkv_op(x, w, b, heads)


area_attention_qkv_fused.launches = 0         # calls that launched
area_attention_qkv_fused.device_launches = 0  # device kernels they started
area_attention_qkv_fused.path_launches = {}   # "short bf16" etc. -> launches
area_attention_qkv_fused.backward_calls = 0


# ------------------------------------------------------------- kernel C

def _heads_view(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(G, N, C) head-major channels -> (G, heads, N, hd)."""
    g, n, c = t.shape
    return t.reshape(g, n, heads, c // heads).transpose(1, 2)


def area_attention_fused_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, heads: int,
                               scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version, the math of the JAX package's
    `area_attention_fused_reference`: per head softmax(q k^T * scale) in
    f32 (scale hd ** -0.5 unless given: a padded head keeps its true one),
    probabilities rounded to v.dtype, p.v accumulated in f32, heads
    concatenated back to C. Differentiable by autograd."""
    g, n, c = q.shape
    hd = c // heads
    scale = hd ** -0.5 if scale is None else scale
    s = torch.matmul(_heads_view(q, heads).float(),
                     _heads_view(k, heads).float().transpose(-1, -2)) * scale
    p = s.softmax(-1).to(v.dtype).float()
    o = torch.matmul(p, _heads_view(v, heads).float())
    return o.transpose(1, 2).reshape(g, n, c).to(q.dtype)


def area_attention_plain(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """Plain single-head version over (G, N, hd), the math of the JAX
    package's `area_attention_reference`."""
    return area_attention_fused_plain(q, k, v, 1)


def _check_qkv(q, k, v, heads):
    if q.dim() != 3:
        raise ValueError(f"q must be (G, N, C), got {tuple(q.shape)}")
    g, n, c = q.shape
    if heads <= 0 or c % heads:
        raise ValueError(f"C={c} is not a multiple of heads={heads}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (k.shape == v.shape == q.shape):
        raise ValueError(f"q, k and v must share a shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    return g, n, c


def _launch_band_attention(q, k, v, heads, path=None, rows=None,
                           scale=None):
    """Launch kernel C on contiguous CUDA tensors whose heads are a kernel
    width (32, 64 or a multiple of 64), or a width the kernel pads itself
    (`in_kernel_pad`: planned and run as the kernel width holding it), on
    the path `attention_plan` gives (`path`, one of `PATHS`, forces one, for
    comparisons; `rows` the streamed CTA's query rows or the short path's
    tile rows in place of the planned ones); `scale` the softmax's (default
    hd ** -0.5); returns o."""
    g, n, c = q.shape
    hd = c // heads
    padded = in_kernel_pad(hd, q.dtype)
    hdk = padded_head_dim(hd) if padded else _kernel_head_dim(c, heads)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if path is None:
        path = attention_plan(g, n, heads * hdk, q.dtype, projection=False,
                              hd=hdk).path
    _check_path(path, n, projection=False, hd=hdk)
    lib = build.load()
    _check_aligned(q, k, v)
    o = torch.empty_like(q)
    if path in ("streamed", "blocked"):   # one C entry, by head width
        entry = (lib.yolou_band_attention_stream_padded if padded
                 else lib.yolou_band_attention_stream)
        rows = rows or _stream_plan(g, n, heads * hdk, q.dtype, False, hdk,
                                    path).rows
    else:
        entry = (lib.yolou_band_attention_short_padded if padded
                 else lib.yolou_band_attention_short)
        rows = rows or short_rows(g, n, heads * hdk, q.dtype, hdk,
                                  projection=False)
    # the padded entries take (heads, hd), the others (C, heads)
    shape = (g, n, heads, hd) if padded else (g, n, c, heads)
    with torch.cuda.device(q.device):
        code = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     *shape, _DTYPE_CODE[q.dtype], rows,
                     hd ** -0.5 if scale is None else scale,
                     torch.cuda.current_stream().cuda_stream)
    build.check(lib, code, "band attention (training) kernel")
    return o


def _band_attention(q, k, v, heads, wrapper):
    """Kernel C on a CUDA tensor (counted on `wrapper`, the public function
    called), the plain version at the true width on a CPU tensor. On the
    card heads whose width is no kernel width are held as `padded_head_dim`
    with the true scale: inside the kernel where `in_kernel_pad` admits
    them, else by copies (`pad_heads`, then `cut_heads`)."""
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"no kernel for device {q.device}")
    if q.device.type == "cpu":
        return area_attention_fused_plain(q, k, v, heads)
    g, n, c = q.shape
    hd = c // heads
    hdp = padded_head_dim(hd)
    padded = in_kernel_pad(hd, q.dtype)
    path = attention_plan(g, n, heads * hdp, q.dtype, projection=False,
                          hd=hdp).path
    if hdp == hd or padded:
        o = _launch_band_attention(q, k, v, heads, path, scale=hd ** -0.5)
    else:
        o = cut_heads(_launch_band_attention(
            *(pad_heads(t, heads, hdp) for t in (q, k, v)), heads, path,
            scale=hd ** -0.5), heads, hd)
    wrapper.launches += 1
    _count_path(wrapper, path, q.dtype, padded)
    return o


def attention_backward(q, k, v, do, heads: int):
    """(dq, dk, dv) of `area_attention_fused` for the cotangent `do`: scores
    and softmax recomputed in f32, ds = p * (dp - sum(dp * p)), results cast
    to the inputs' types."""
    g, n, c = q.shape
    scale = (c // heads) ** -0.5
    qh, kh, vh, doh = (_heads_view(t, heads).float() for t in (q, k, v, do))
    p = (torch.matmul(qh, kh.transpose(-1, -2)) * scale).softmax(-1)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    dq = torch.matmul(ds, kh) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qh) * scale

    def back(t, ref):
        return t.transpose(1, 2).reshape(g, n, c).to(ref.dtype)

    return back(dq, q), back(dk, k), back(dv, v)


@torch.library.custom_op(
    "yolou::band_attention", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int heads) -> Tensor")
def band_attention_op(q, k, v, heads):
    """Kernel C as an operator, multi-head."""
    return _band_attention(q, k, v, heads, area_attention_fused)


@torch.library.custom_op(
    "yolou::band_attention_single", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v) -> Tensor")
def band_attention_single_op(q, k, v):
    """Kernel C as an operator with one head."""
    return _band_attention(q, k, v, 1, area_attention)


def _attention_setup(ctx, inputs, output):
    q, k, v, *heads = inputs          # heads: given to the multi-head op
    ctx.save_for_backward(q, k, v)
    ctx.heads, ctx.n_ints = (heads or [1])[0], len(heads)


def _attention_backward(wrapper):
    """Backward of a kernel C operator, on both devices:
    `attention_backward`, counted on `wrapper`; saves q, k, v only."""
    def backward(ctx, do):
        wrapper.backward_calls += 1
        return (*attention_backward(*ctx.saved_tensors, do, ctx.heads),
                *[None] * ctx.n_ints)
    return backward


def area_attention_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         heads: int) -> torch.Tensor:
    """Multi-head softmax attention over (G, N, C) bands, C = heads * hd with
    head-major channels (channel = h * hd + d): per head
    softmax(q_h k_h^T / sqrt(hd)) v_h, outputs concatenated back to C.
    float32 or bfloat16, contiguous, any N >= 1. Differentiable."""
    _check_qkv(q, k, v, heads)
    return band_attention_op(q, k, v, heads)


def area_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Single-head softmax attention over (G, N, hd) bands: the same kernel
    with heads = 1. Differentiable."""
    _check_qkv(q, k, v, 1)
    return band_attention_single_op(q, k, v)


for _op, _fn in ((band_attention_op, area_attention_fused),
                 (band_attention_single_op, area_attention)):
    _op.register_fake(lambda q, *_: torch.empty_like(q))
    _op.register_autograd(_attention_backward(_fn),
                          setup_context=_attention_setup)
    _fn.launches = 0         # forward kernel launches
    _fn.path_launches = {}   # "short bf16" etc. -> launches
    _fn.backward_calls = 0   # calls of the backward
