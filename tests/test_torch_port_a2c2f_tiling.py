"""PyTorch port: the blocking of the bf16 whole-A2C2f kernel's attention and
the loop of the one-launch greedy NMS kernel, emulated on the CPU, against
the JAX package's Pallas kernels in interpret mode.

The CUDA kernels run only on the card; what the CPU can check is their
order of operations.

`split_attention` repeats the bf16 `a2c2f_mma_kernel`'s attention
(`csrc/a2c2f.cu`, `csrc/attention_mma.cuh`): per head, 16-row query tiles;
the band's keys cut into S parts of whole 16-key blocks (part s takes blocks
[s * n / S, (s + 1) * n / S), S = 8 warps / query tiles of the token tile:
8, 4 or 2); each part an online softmax in steps of KT = 64 keys, the exp
against the part's running maximum rounded to the I/O type for p.v, its f32
row sum unrounded; then the merge o = sum_s acc_s e^(m_s - M) / sum_s l_s
e^(m_s - M), M the largest part maximum, in f32; that f32 o goes to the
`+ pe` epilogue. Put into `a2c2f_fused_plain` in place of its full-row
attention and held against the Pallas `a2c2f_fused` (interpret mode) at
`tests/test_torch_port_a2c2f.py`'s shapes:
  * float32: within 1e-5 (the same function, f32 sums in another order);
  * bfloat16: within 2**-6 of the output's largest magnitude: a probability
    rounded against another maximum moves by at most one bf16 step (2**-8
    relative), the block's own roundings by about one more each.

`nms_emulated` repeats `csrc/greedy_nms.cu` bit for bit: the valid,
removed and kept bitsets as 32-bit words; per round one warp finds the next
64-row window that holds a candidate (valid & ~removed, a ballot over the
64-bit words, the first set lane); the members of the window are tested
against each other; one warp keeps member p iff no kept member before it
hits it; 16 warps of 32 threads test the later candidates against the
window's kept members, whose ballot words are ORed into `removed`; the
compare in f32 with every operation rounded on its own (numpy float32 does
not fuse). Held against `suppress_greedy_fused` (interpret mode) and
the port's `suppress_greedy_plain`: identical keep-sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_a2c2f import a2c2f_fused as jax_a2c2f
from yolou_tpu.ops.pallas_nms import suppress_greedy_fused as jax_nms
from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused_plain
from yolou_tpu_torch.kernels.nms import suppress_greedy_plain

from .test_torch_port_a2c2f import CASES, _cast, _weights

ROWS = 16          # query rows per warp tile
KT = 64            # keys per online-softmax step
WARPS = 8
THREADS = 512      # threads of a greedy NMS CTA


def split_attention(parts: int):
    """The kernel's attention with the keys of a band cut into `parts`:
    a drop-in for `band_attention_plain` over (G, heads, nb, hd) f32."""

    def attend(q, k, v, dtype):
        nb, hd = q.shape[-2:]
        scale = hd ** -0.5
        blocks = -(-nb // 16)
        out = torch.empty_like(q)
        for r0 in range(0, nb, ROWS):
            qt = q[..., r0:r0 + ROWS, :]
            states = []
            for s in range(parts):
                kb = 16 * (s * blocks // parts)
                ke = 16 * ((s + 1) * blocks // parts)
                ke = min(ke, nb)            # keys past nb are masked
                m = torch.full(qt.shape[:-1] + (1,), -torch.inf)
                l = torch.zeros_like(m)
                acc = torch.zeros_like(qt)
                for k0 in range(kb, ke, KT):
                    k1 = min(k0 + KT, ke)
                    sc = qt @ k[..., k0:k1, :].transpose(-1, -2) * scale
                    m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                    p = torch.exp(sc - m_new)
                    c = torch.exp(m - m_new)
                    l = l * c + p.sum(-1, keepdim=True)
                    acc = acc * c + p.to(dtype).float() @ v[..., k0:k1, :]
                    m = m_new
                states.append((m, l, acc))
            big_m = torch.stack([m for m, _, _ in states]).amax(0)
            num = sum(acc * torch.exp(m - big_m) for m, _, acc in states)
            den = sum(l * torch.exp(m - big_m) for m, l, _ in states)
            out[..., r0:r0 + ROWS, :] = num / den
        return out

    return attend


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(scope="module")
def pallas_outputs():
    """(case, dtype name) -> (x, torch weights, the Pallas kernel's output
    in interpret mode as f32 numpy): one interpret run each."""
    out = {}
    for i, (shape, cfg) in enumerate(CASES):
        rng = np.random.default_rng(10 + i)
        x = rng.normal(0, 0.5, shape).astype(np.float32)
        ws = _weights(rng, shape[-1], cfg["c_"], cfg["c2"], cfg["n_stages"])
        for name, tdt, jdt in DTYPES:
            jw, tw = _cast(ws, jdt, tdt)
            want = jax_a2c2f(jnp.asarray(x).astype(jdt), jw, cfg["n_stages"],
                             cfg["area"], cfg["heads"], interpret=True)
            out[(i, name)] = (torch.from_numpy(x).to(tdt), tw,
                              np.asarray(want.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("parts", [8, 4, 2], ids=["tile16", "tile32",
                                                  "tile64"])
@pytest.mark.parametrize("name,dtype", [(d[0], d[1]) for d in DTYPES],
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_split_attention_block_matches_pallas(pallas_outputs, case, name,
                                              dtype, parts):
    """The whole block with the bf16 kernel's split attention against the
    Pallas kernel; and against the port's plain version, which attends
    each band's full row at once."""
    shape, cfg = CASES[case]
    x, tw, want = pallas_outputs[(case, name)]
    args = (cfg["n_stages"], cfg["area"], cfg["heads"])
    got = a2c2f_fused_plain(x, tw, *args, attention=split_attention(parts))
    assert got.dtype == dtype and got.shape == shape[:3] + (cfg["c2"],)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    plain = a2c2f_fused_plain(x, tw, *args)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name,dtype", [(d[0], d[1]) for d in DTYPES],
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("nb", [25, 60, 400])
def test_split_attention_matches_the_full_row(nb, name, dtype):
    """At the card tests' ragged bands and the serving band of 400 keys
    (parts of up to 208 keys, several 64-key steps each): the split form
    against `band_attention_plain`, which softmaxes each row at once, at
    the tolerances above."""
    from yolou_tpu_torch.kernels.a2c2f import band_attention_plain
    rng = np.random.default_rng(nb)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, nb, 32))
                                .astype(np.float32)).to(dtype).float()
               for _ in range(3))
    want = band_attention_plain(q, k, v, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * want.abs().max()
    for parts in (8, 4, 2):
        got = split_attention(parts)(q, k, v, dtype)
        assert (got - want).abs().max().item() <= tol, parts


def test_split_parts_cover_every_key_once():
    """The S parts of whole 16-key blocks partition the padded band, and
    the first key of every part that has one is a real key (so each part's
    running maximum is finite from its first step): at the band lengths
    of the card tests and of the serving path."""
    for nb in (1, 15, 16, 25, 60, 63, 64, 100, 400, 1600):
        blocks = -(-nb // 16)
        for parts in (8, 4, 2):
            cuts = [16 * (s * blocks // parts) for s in range(parts + 1)]
            assert cuts[0] == 0 and cuts[-1] == 16 * blocks
            assert all(a <= b for a, b in zip(cuts, cuts[1:]))
            assert all(a < nb for a, b in zip(cuts, cuts[1:]) if a < b)


# ------------------------------------------------------------- greedy NMS

def _area(b):
    return (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])


def nms_emulated(boxes: np.ndarray, valid: np.ndarray, t: float):
    """One image through greedy_nms.cu's loop; returns (keep, the kept rows
    in the order the loop decided them)."""
    boxes = boxes.astype(np.float32)
    k = len(boxes)
    t = np.float32(t)
    words = -(-k // 64)
    bits = np.zeros(64 * words, bool)
    bits[:k] = valid

    def pack(b):              # 32 rows per word, row 32w + i is bit i
        return int((b.astype(np.uint64) << np.arange(32, dtype=np.uint64))
                   .sum())

    valid32 = [pack(bits[32 * w:32 * w + 32]) for w in range(2 * words)]
    removed32 = [0] * (2 * words)
    kept32 = [0] * (2 * words)
    area = _area(boxes)

    def over(j, i):           # row j (earlier) against rows i, f32
        r, c = boxes[j], boxes[i]
        iw = np.maximum(np.minimum(r[..., 2], c[..., 2])
                        - np.maximum(r[..., 0], c[..., 0]), np.float32(0))
        ih = np.maximum(np.minimum(r[..., 3], c[..., 3])
                        - np.maximum(r[..., 1], c[..., 1]), np.float32(0))
        inter = iw * ih
        uni = (area[j] + area[i]) - inter
        return inter > t * (uni + np.float32(1e-7))

    decided = []
    w0 = 0
    while True:
        # 1. one warp: lane w holds 64-bit word w of valid & ~removed
        cand = [(valid32[2 * w] | valid32[2 * w + 1] << 32)
                & ~(removed32[2 * w] | removed32[2 * w + 1] << 32)
                if w >= w0 else 0 for w in range(words)]
        live = [w for w in range(words) if cand[w]]
        if not live:
            break
        w = live[0]                                  # the ballot's first lane
        members, base = cand[w], 64 * w
        # 2. member p < i against member i: 32 bits (one ballot) per task
        hits = [0] * 64
        for i in range(64):
            for p in range(i):
                if members >> i & members >> p & 1 and over(base + p,
                                                            base + i):
                    hits[i] |= 1 << p
        # 3. one warp decides the window in row order
        kmask = 0
        for p in range(64):
            if members >> p & 1 and not hits[p] & kmask:
                kmask |= 1 << p
                decided.append(base + p)
        kept32[2 * w] = kmask & 0xFFFFFFFF
        kept32[2 * w + 1] = kmask >> 32
        # 4. later rows against the kept members, a ballot word a warp
        for rbase in range(base + 64, k, THREADS):
            for warp in range(THREADS // 32):
                word = 0
                for lane in range(32):
                    i = rbase + 32 * warp + lane
                    if i >= k or not ((valid32[i >> 5] & ~removed32[i >> 5])
                                      >> (i & 31) & 1):
                        continue
                    kept_rows = [base + p for p in range(64) if kmask >> p & 1]
                    if kept_rows and over(np.array(kept_rows), i).any():
                        word |= 1 << lane
                if word:
                    removed32[(rbase >> 5) + warp] |= word
        w0 = w + 1
    keep = np.array([kept32[i >> 5] >> (i & 31) & 1 for i in range(k)], bool)
    return keep, decided


def _nms_layout(k, layout, rng):
    """(boxes (k, 4) f32 sorted as by score, valid (k,) bool)."""
    valid = np.ones(k, bool)
    if layout == "random":
        xy = rng.random((k, 2), np.float32) * 300
        wh = rng.random((k, 2), np.float32) * 80 + 8
        valid = rng.random(k) < 0.9
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


@pytest.mark.parametrize("layout", ["random", "none", "cluster", "disjoint"])
@pytest.mark.parametrize("k", [1, 63, 64, 65, 512, 2048])
def test_nms_loop_matches_pallas_and_plain(k, layout):
    boxes, valid = _nms_layout(k, layout, np.random.default_rng(k))
    keep, decided = nms_emulated(boxes, valid, 0.45)
    # the loop keeps rows in increasing order, each once
    assert decided == list(np.flatnonzero(keep))
    want = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(valid), 0.45,
                              interpret=True))
    np.testing.assert_array_equal(keep, want)
    plain = suppress_greedy_plain(torch.from_numpy(boxes)[None],
                                  torch.from_numpy(valid)[None], 0.45)[0]
    np.testing.assert_array_equal(keep, plain.numpy())
    if layout == "none":
        assert not keep.any()
    elif layout == "cluster":
        assert keep.sum() == 1
    elif layout == "disjoint":
        assert keep.all()
