"""PyTorch port: the blocking of the bf16 whole-A2C2f kernel's attention and
the two phases of the one-launch greedy NMS kernel, emulated on the CPU,
against the JAX package's Pallas kernels in interpret mode.

The CUDA kernels run only on the card; what the CPU can check is their
order of operations.

`streamed_attention` repeats the bf16 `a2c2f_wgmma_kernel`'s attention
(`csrc/a2c2f_bf16.cu`): per head, the query rows a consumer warpgroup takes
(the token tile, 64 or 32 rows, of one band); the band's keys in the k/v
ring's tiles of 128 (keys past the band masked); one online softmax over
them, the exp against the running row maximum rounded to the I/O type as
p.v's operand, its f32 row sum unrounded, the f32 accumulator rescaled by
each new maximum; no merge of partial states; then the division by the row
sum, and that f32 o goes to the `+ pe` epilogue. Put into
`a2c2f_fused_plain` in place of its full-row attention and held against the
Pallas `a2c2f_fused` (interpret mode) at `tests/test_torch_port_a2c2f.py`'s
shapes, with heads as the kernel takes them (32 wide, or padded with zero
channels to 64 by `pad_a2c2f_heads`, the true scale kept):
  * float32: within 1e-5 (the same function, f32 sums in another order);
  * bfloat16: within 2**-6 of the output's largest magnitude: a probability
    rounded against another maximum moves by at most one bf16 step (2**-8
    relative), the block's own roundings by about one more each.

`nms_emulated` runs one image through `csrc/greedy_nms.cu`'s two phases
(`test_torch_port_nms_cluster.py::nms_cluster_emulated`: the IoU tests as
bits in the cluster's slabs, then the chain over 64-row windows on bits
alone) and lists the kept rows in the order the chain decided their
windows. Held against `suppress_greedy_fused` (interpret mode) and the
port's `suppress_greedy_plain`: identical keep-sets.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_a2c2f import a2c2f_fused as jax_a2c2f
from yolou_tpu.ops.pallas_nms import suppress_greedy_fused as jax_nms
from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused_plain, pad_a2c2f_heads
from yolou_tpu_torch.kernels.nms import suppress_greedy_plain

from .test_torch_port_a2c2f import CASES, _cast, _weights
from .test_torch_port_nms_cluster import nms_cluster_emulated
from .torch_threads import one_torch_thread  # noqa: F401

KEYS = 128         # keys a k/v tile of the ring


def key_tiles(nb: int) -> list:
    """The ring's key tiles of one head: [k0, k0 + 128) for k0 < nb, the
    last cut at nb (the kernel masks the keys past the band)."""
    return [(k0, min(k0 + KEYS, nb)) for k0 in range(0, nb, KEYS)]


def streamed_attention(rows: int):
    """The kernel's attention with query tiles of `rows` rows: a drop-in
    for `band_attention_plain` over (G, heads, nb, hd) f32."""

    def attend(q, k, v, dtype, scale=None):
        nb, hd = q.shape[-2:]
        scale = hd ** -0.5 if scale is None else scale
        out = torch.empty_like(q)
        for r0 in range(0, nb, rows):
            qt = q[..., r0:r0 + rows, :]
            m = torch.full(qt.shape[:-1] + (1,), -torch.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros_like(qt)
            for k0, k1 in key_tiles(nb):
                sc = qt @ k[..., k0:k1, :].transpose(-1, -2) * scale
                m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
                p = torch.exp(sc - m_new)
                c = torch.exp(m - m_new)
                l = l * c + p.sum(-1, keepdim=True)
                acc = acc * c + p.to(dtype).float() @ v[..., k0:k1, :]
                m = m_new
            out[..., r0:r0 + rows, :] = acc / l
        return out

    return attend


DTYPES = [("float32", torch.float32, jnp.float32),
          ("bfloat16", torch.bfloat16, jnp.bfloat16)]
# (query rows of a tile, head width as the kernel takes it)
LAYOUTS = {"tile64": (64, 32), "tile32": (32, 32), "tile64-hd64": (64, 64)}


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


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name,dtype", [(d[0], d[1]) for d in DTYPES],
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_streamed_attention_block_matches_pallas(pallas_outputs, case, name,
                                                 dtype, layout):
    """The whole block with the bf16 kernel's streamed attention against the
    Pallas kernel; and against the port's plain version, which attends
    each band's full row at once. At head width 64 the heads are padded
    with zero channels, as the wrapper gives them to the kernel."""
    shape, cfg = CASES[case]
    x, tw, want = pallas_outputs[(case, name)]
    args = (cfg["n_stages"], cfg["area"], cfg["heads"])
    rows, hd = LAYOUTS[layout]
    kw = list(tw)
    if hd != cfg["c_"] // cfg["heads"]:
        kw = pad_a2c2f_heads(kw, cfg["n_stages"], cfg["heads"], hd)
    got = a2c2f_fused_plain(x, kw, *args, attention=streamed_attention(rows))
    assert got.dtype == dtype and got.shape == shape[:3] + (cfg["c2"],)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)
    plain = a2c2f_fused_plain(x, tw, *args)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               rtol=0, atol=tol)


@pytest.mark.parametrize("name,dtype", [(d[0], d[1]) for d in DTYPES],
                         ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("nb", [25, 60, 400])
def test_streamed_attention_matches_the_full_row(nb, name, dtype):
    """At the card tests' ragged bands and the serving band of 400 keys
    (four key tiles, the last of 16 keys): the streamed form at both token
    tiles against `band_attention_plain`, which softmaxes each row at once,
    at the tolerances above."""
    from yolou_tpu_torch.kernels.a2c2f import band_attention_plain
    rng = np.random.default_rng(nb)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 2, nb, 32))
                                .astype(np.float32)).to(dtype).float()
               for _ in range(3))
    want = band_attention_plain(q, k, v, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -6 * want.abs().max()
    for rows in (64, 32):
        got = streamed_attention(rows)(q, k, v, dtype)
        assert (got - want).abs().max().item() <= tol, rows


def test_key_tiles_cover_every_key_once():
    """The ring's tiles of 128 keys partition the band, each starts on a
    real key (so the running maximum is finite from the first tile on),
    and only the last is cut: at the band lengths of the card tests and of
    the serving path."""
    for nb in (1, 15, 16, 25, 60, 63, 64, 100, 128, 129, 400, 1600, 3136):
        tiles = key_tiles(nb)
        assert tiles[0][0] == 0 and tiles[-1][1] == nb
        assert all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
        assert all(k0 < nb and 0 < k1 - k0 <= KEYS for k0, k1 in tiles)
        assert all(k1 - k0 == KEYS for k0, k1 in tiles[:-1])


# ------------------------------------------------------------- greedy NMS

def nms_emulated(boxes: np.ndarray, valid: np.ndarray, t: float):
    """One image through greedy_nms.cu's two phases; returns (keep, the
    kept rows in the order the chain decided them: window by window)."""
    keep, _ = nms_cluster_emulated(boxes, valid, t)
    decided = [i for w in range(0, len(keep), 64)
               for i in range(w, min(w + 64, len(keep))) if keep[i]]
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
