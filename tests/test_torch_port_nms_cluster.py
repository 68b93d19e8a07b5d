"""PyTorch port: the greedy NMS kernel's two phases (`csrc/greedy_nms.cu`:
a thread-block cluster per image, the IoU tests as bits first, then the
greedy chain over bits), emulated on the CPU, against the JAX package.

The CUDA kernel runs only on the card; what the CPU can check is its
algorithm. `nms_cluster_emulated` repeats it on one image:
  * the shape: W = ceil(K / 64) windows of 64 columns in slabs of at most 8
    windows, one slab per owner CTA, S = ceil(W / 8) owners, owner s
    holding the windows [s W / S, (s + 1) W / S); a cluster of N >= S CTAs
    (enough for each warp to take one block of phase 1; at most 16 with one
    owner, 8 with more);
  * phase 1: the 32 x 32 blocks (row block rb, column block cb) whose row
    window is at most the column's, 2 W (W + 1) of them in the kernel's
    order; a block without a valid row or column is a zero word, untested;
    else each column's 32 bits (j < i, valid_j, the division-free compare
    in f32 with every operation rounded on its own: numpy float32 does not
    fuse) are one 32-bit half of the 64-bit word hc[i][rb / 2], stored in
    the column owner's slab, whose words start as garbage: every word phase
    2 reads must have been written;
  * phase 2: the owners in order; owner s decides its windows in order: a
    window's candidates are its valid columns that no kept row of an
    earlier window hits (hc[i][w'] & kept[w'] over every earlier window
    w'), its kept set the fixpoint keep = cand & ~(rows of keep that hit)
    over the window's diagonal word, from keep = cand; the kept masks go to
    the later owners.
Held against the Pallas `suppress_greedy_fused` (vmapped over images,
interpret mode) and the JAX package's `ops/nms.py::_suppress_greedy` over
`box_iou`: identical keep-sets, at K = 1, 63, 64, 65, 300 and 1000 (one and
two owners), with threshold ties on a lattice (IoU exactly 1/2 at the
threshold 1/2), no valid row, one cluster of jittered boxes (one kept) and
disjoint boxes (all kept). The kernel's constants are the source's.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.boxes import box_iou
from yolou_tpu.ops.nms import _suppress_greedy
from yolou_tpu.ops.pallas_nms import suppress_greedy_fused as jax_nms
from yolou_tpu_torch.kernels import nms as port_nms
from yolou_tpu_torch.kernels.nms import suppress_greedy

from .torch_threads import one_torch_thread  # noqa: F401

MAX_CTAS = 16      # a cluster's CTAs, at most (the non-portable size)
SLAB = 8           # windows an owner holds, at most
WARPS = 16         # warps of a CTA
GARBAGE = 0xA5A5A5A5A5A5A5A5


class Shape:
    """greedy_nms.cu's `Shape`: W windows over S owners in N CTAs."""

    def __init__(self, k: int):
        self.k, self.w = k, -(-k // 64)
        blocks = 2 * self.w * (self.w + 1)
        self.s = -(-self.w // SLAB)
        self.sw = -(-self.w // self.s)
        self.n = max(self.s, min(MAX_CTAS if self.s == 1 else MAX_CTAS // 2,
                                 -(-blocks // WARPS)))
        self.cs = self.w | 1

    def lo(self, s: int) -> int:
        return s * self.w // self.s if s < self.s else self.w

    def owner(self, w: int) -> int:
        return ((w + 1) * self.s - 1) // self.w

    def bytes(self) -> int:
        """Its dynamic shared memory: boxes, hc, kept masks, the mbarrier,
        areas, valid bits; boxes and areas of 64 W rows."""
        return (16 * 64 * self.w + 8 * (64 * self.sw * self.cs + self.w + 1)
                + 4 * 64 * self.w + 8 * self.w)


def _overlaps(boxes, area, rows, cols, t):
    """hit-test of rows (earlier) against cols, f32, the kernel's order;
    (len(rows), len(cols)) bool."""
    r, c = boxes[rows][:, None], boxes[cols][None, :]
    zero = np.float32(0)
    iw = np.maximum(np.minimum(r[..., 2], c[..., 2])
                    - np.maximum(r[..., 0], c[..., 0]), zero)
    ih = np.maximum(np.minimum(r[..., 3], c[..., 3])
                    - np.maximum(r[..., 1], c[..., 1]), zero)
    inter = iw * ih
    uni = (area[rows][:, None] + area[cols][None, :]) - inter
    return inter > t * (uni + np.float32(1e-7))


def _items(w_count: int):
    """Phase 1's blocks (cw, cb, rb) in the kernel's order."""
    for q in range(2 * w_count * (w_count + 1)):
        cw = 0
        while 2 * (cw + 1) * (cw + 2) <= q:
            cw += 1
        rem, per = q - 2 * cw * (cw + 1), 2 * cw + 2
        yield cw, 2 * cw + rem // per, rem % per


def nms_cluster_emulated(boxes: np.ndarray, valid: np.ndarray, t: float):
    """One image through greedy_nms.cu's two phases; returns (keep, the
    fixpoint iterations of each window's decision)."""
    boxes = boxes.astype(np.float32)
    t = np.float32(t)
    sh = Shape(len(boxes))
    k, w_count = sh.k, sh.w
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    vbits = np.zeros(64 * w_count, bool)
    vbits[:k] = valid
    padded = np.zeros((64 * w_count, 4), np.float32)
    padded[:k] = boxes
    parea = np.zeros(64 * w_count, np.float32)
    parea[:k] = area

    # phase 1: hc[s][local column][row word], garbage until written
    hc = [[[GARBAGE] * w_count for _ in range(64 * sh.sw)]
          for _ in range(sh.s)]
    written = [[[0] * w_count for _ in range(64 * sh.sw)]
               for _ in range(sh.s)]
    for cw, cb, rb in _items(w_count):
        rows = np.arange(32 * rb, 32 * rb + 32)
        cols = np.arange(32 * cb, 32 * cb + 32)
        words = [0] * 32
        if vbits[rows].any() and vbits[cols].any() and rb <= cb:
            hit = (_overlaps(padded, parea, rows, cols, t)
                   & vbits[rows][:, None] & vbits[cols][None, :]
                   & (rows[:, None] < cols[None, :]))
            words = [int((hit[:, c].astype(np.uint64)
                          << np.arange(32, dtype=np.uint64)).sum())
                     for c in range(32)]
        own = sh.owner(cw)
        for c in range(32):
            lc = 32 * cb + c - 64 * sh.lo(own)
            word, half = hc[own][lc][rb >> 1], rb & 1
            keep_half = word & (0xFFFFFFFF << (32 * (1 - half)))
            hc[own][lc][rb >> 1] = keep_half | words[c] << (32 * half)
            written[own][lc][rb >> 1] |= 1 << half

    def read(s, lc, w):            # a word phase 2 reads: both halves set
        assert written[s][lc][w] == 3, (s, lc, w)
        return hc[s][lc][w]

    # phase 2: the chain
    kept_of = {}                   # window -> its kept mask
    keep = np.zeros(k, bool)
    iterations = []
    for r in range(sh.s):
        w_lo = sh.lo(r)
        for w in range(w_lo, sh.lo(r + 1)):
            base = 64 * (w - w_lo)
            cand = [bool(vbits[64 * w + p])
                    and not any(read(r, base + p, w2) & kept_of[w2]
                                for w2 in range(w))
                    for p in range(64)]
            h = [read(r, base + p, w) for p in range(64)]
            km = sum(1 << p for p in range(64) if cand[p])
            steps = 0
            while True:
                steps += 1
                nxt = sum(1 << p for p in range(64)
                          if cand[p] and not h[p] & km)
                if nxt == km:
                    break
                km = nxt
            iterations.append(steps)
            for p in range(64):
                if 64 * w + p < k:
                    keep[64 * w + p] = bool(km >> p & 1)
            kept_of[w] = km
    return keep, iterations


def _layout(k, layout, rng):
    """(boxes (k, 4) f32 sorted as by score, valid (k,) bool)."""
    valid = np.ones(k, bool)
    if layout == "random":
        xy = rng.random((k, 2), np.float32) * 300
        wh = rng.random((k, 2), np.float32) * 80 + 8
        valid = rng.random(k) < 0.9
    elif layout == "dense":             # few kept, long suppression chains
        xy = rng.random((k, 2), np.float32) * 40 + 100
        wh = rng.random((k, 2), np.float32) * 60 + 20
    elif layout == "ties":              # IoU exactly 1/2 between neighbours
        i = np.arange(k)
        xy = np.stack([i % 40, (i // 40) % 8], -1).astype(np.float32)
        wh = np.broadcast_to(np.float32([3, 1]), (k, 2))
    elif layout == "none":
        xy = rng.random((k, 2), np.float32) * 300
        wh = rng.random((k, 2), np.float32) * 80 + 8
        valid[:] = False
    elif layout == "cluster":           # one box jittered: one kept
        xy = np.float32(50) + rng.random((k, 2), np.float32) * 0.05
        wh = np.full((k, 2), 100, np.float32)
    else:                               # "disjoint": never touching, all kept
        i = np.arange(k)
        xy = np.stack([10 * (i % 64), 10 * (i // 64)], -1).astype(np.float32)
        wh = np.full((k, 2), 5, np.float32)
    return np.concatenate([xy, xy + wh], -1).astype(np.float32), valid


KS = [1, 63, 64, 65, 300, 1000]
LAYOUTS = ["random", "dense", "ties", "none", "cluster", "disjoint"]
SEEDS = (0, 1)


def _thres(layout):
    return 0.5 if layout == "ties" else 0.45


@jax.jit
def _xla(boxes, valid, t):
    return jax.vmap(lambda b, v: _suppress_greedy(box_iou(b, b), v, t))(
        boxes, valid)


@pytest.fixture(scope="module")
def jax_keeps():
    """(k, layout, seed) -> (Pallas keep, XLA keep): every image of a
    threshold padded with invalid rows to one of three candidate counts (as
    `suppress_greedy_fused` pads K to a multiple of 128 itself, so padding
    rows can neither hit nor be kept) and vmapped, so each count and
    threshold compiles once."""
    out = {}
    for pad in (128, 384, 1024):
        for t in (0.45, 0.5):
            keys = [(k, lay, s) for k in KS for lay in LAYOUTS for s in SEEDS
                    if _pad(k) == pad and _thres(lay) == t]
            boxes = np.zeros((len(keys), pad, 4), np.float32)
            valid = np.zeros((len(keys), pad), bool)
            for i, (k, lay, s) in enumerate(keys):
                boxes[i, :k], valid[i, :k] = _layout(
                    k, lay, np.random.default_rng(k + s))
            jb, jv = jnp.asarray(boxes), jnp.asarray(valid)
            pallas = np.asarray(jax.vmap(
                lambda b, v: jax_nms(b, v, t, interpret=True))(jb, jv))
            xla = np.asarray(_xla(jb, jv, t))
            for i, (k, lay, s) in enumerate(keys):
                out[(k, lay, s)] = pallas[i, :k], xla[i, :k]
    return out


def _pad(k):
    return 128 if k <= 128 else 384 if k <= 384 else 1024


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("k", KS)
def test_cluster_nms_matches_pallas_and_xla(k, layout, jax_keeps):
    """Two images per case (two seeds) through the emulation, against the
    Pallas kernel vmapped over images and the XLA fixpoint over
    `box_iou`."""
    for s in SEEDS:
        boxes, valid = _layout(k, layout, np.random.default_rng(k + s))
        keep, iterations = nms_cluster_emulated(boxes, valid, _thres(layout))
        pallas, xla = jax_keeps[(k, layout, s)]
        np.testing.assert_array_equal(keep, pallas)
        np.testing.assert_array_equal(keep, xla)
        assert max(iterations) <= 65
        if layout == "none":
            assert not keep.any()
        elif layout == "cluster":
            assert keep.sum() == 1
        elif layout == "disjoint":
            assert keep.all()


def test_slabs_cover_every_window_once():
    """Every window has one owner, slabs are contiguous, at most SLAB wide,
    and fit a CTA's shared memory; the cluster has an owner per slab and at
    most MAX_CTAS CTAs; phase 1's blocks cover each owned column's row words
    up to its own window, each half once, for every K the kernel takes."""
    for k in list(range(1, 300)) + [511, 512, 513, 1000, 2047, 2048]:
        sh = Shape(k)
        owners = [sh.owner(w) for w in range(sh.w)]
        assert owners == sorted(owners) and owners[-1] == sh.s - 1
        assert sh.s <= sh.n <= MAX_CTAS
        assert sh.bytes() <= 227 * 1024
        for s in range(sh.s):
            assert 1 <= sh.lo(s + 1) - sh.lo(s) <= sh.sw <= SLAB
            assert all(sh.owner(w) == s
                       for w in range(sh.lo(s), sh.lo(s + 1)))
        if k in (1, 65, 300, 2048):
            seen = {}
            for cw, cb, rb in _items(sh.w):
                assert cb // 2 == cw and rb // 2 <= cw
                key = (cb, rb)
                assert key not in seen
                seen[key] = True
            assert len(seen) == sum(4 * (w + 1) for w in range(sh.w))
    assert (Shape(512).s, Shape(512).n) == (1, 9)       # serving's K
    assert (Shape(2048).s, Shape(2048).n) == (4, 8)


def test_the_constants_are_the_kernels():
    """MAX_K, the cluster size and the block size are the CUDA source's,
    and the wrapper refuses what the kernel does not take."""
    text = (Path(port_nms.__file__).parent.parent / "csrc"
            / "greedy_nms.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))

    assert constant("MAX_K") == port_nms.MAX_K == 2048
    assert constant("MAX_CTAS") == MAX_CTAS
    assert constant("SLAB") == SLAB
    assert constant("THREADS") == 32 * WARPS
    # the plain version on the CPU, whatever the cluster shape
    boxes, valid = _layout(100, "random", np.random.default_rng(0))
    keep = suppress_greedy(torch.from_numpy(boxes)[None],
                           torch.from_numpy(valid)[None], 0.45)[0]
    np.testing.assert_array_equal(keep.numpy(),
                                  nms_cluster_emulated(boxes, valid, 0.45)[0])
