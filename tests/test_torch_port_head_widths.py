"""PyTorch port: attention heads of any width up to 64 and the whole-A2C2f
kernel at any stage count, against the JAX package on the CPU.

The JAX modules build heads `c_ / max(1, c_ // 32)` wide (1-63 channels),
and its Pallas kernels take any width. The port's CUDA kernels are built
for heads of 32 and 64; every other width is padded with zero channels to
the next of the two by one function on both devices (`pad_heads`,
`pad_qkv_projection`, `pad_a2c2f_heads`) and run with the true scale, so
here, on the CPU, the wrappers run the plain versions over the padded
operands. All in f32 against the Pallas kernels in interpret mode within
1e-5 (the same products in another summation order), the gradients within
1e-4 as in `test_torch_port_train_kernels.py`, the whole block within 2e-5
as in `test_torch_port_a2c2f.py`. The f32 kernel's plan (token tile and
shared memory) is held to every shape the routing gate admits.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.nn import attention as jattn
from yolou_tpu.ops.pallas_a2c2f import a2c2f_fused as jax_a2c2f
from yolou_tpu.ops.pallas_attn import area_attention as jax_single
from yolou_tpu.ops.pallas_attn import area_attention_fused as jax_fused
from yolou_tpu.ops.pallas_attn import \
    area_attention_qkv_fused as jax_qkv_fused
from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels import a2c2f as a2c2f_module
from yolou_tpu_torch.kernels.a2c2f import (_SMEM_LIMIT, F32_TILES,
                                           _kernel_weights, _up4, a2c2f_fused,
                                           a2c2f_fused_plain,
                                           a2c2f_mega_eligible,
                                           f32_panel, f32_smem_bytes,
                                           f32_tile,
                                           bf16_plan, pad_a2c2f_heads,
                                           pad_f32_widths)
from yolou_tpu_torch.kernels.attention import (
    KERNEL_HEAD_DIMS, area_attention, area_attention_fused,
    area_attention_fused_plain, area_attention_qkv_fused,
    area_attention_qkv_fused_plain, attention_plan, cut_heads, pad_heads,
    pad_qkv_projection, padded_head_dim)
from yolou_tpu_torch.models.specs import (YOLOV12_SCALES, scale_channels,
                                          scale_depth)
from yolou_tpu_torch.nn import attention

from .test_torch_port_a2c2f import _cast
from .test_torch_port_layers import _close, _init, _load, _nchw
from .torch_threads import one_torch_thread  # noqa: F401

WIDTHS = [8, 16, 40, 48, 63, 32]             # 32: the control
ATOL = 1e-5


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _qkv_inputs(g, n, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, n, c)).astype(np.float32)
    w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c)).astype(np.float32)
    b = rng.normal(0, 0.1, (3 * c,)).astype(np.float32)
    return x, w, b


def test_padded_head_dim_and_the_padding_round_trip():
    """32 up to 32 channels, 64 up to 64, past 64 the next multiple of 64
    (the blocked form's); each head's channels first and zeros after them;
    `cut_heads` undoes `pad_heads`."""
    assert KERNEL_HEAD_DIMS == (32, 64)
    assert [padded_head_dim(h) for h in (1, 8, 32, 33, 48, 63, 64, 65)] == \
        [32, 32, 32, 64, 64, 64, 64, 128]
    t = torch.arange(2 * 5 * 3 * 40, dtype=torch.float32).reshape(2, 5, 120)
    p = pad_heads(t, 3, 64)
    assert p.shape == (2, 5, 192)
    for h in range(3):
        assert torch.equal(p[..., 64 * h:64 * h + 40],
                           t[..., 40 * h:40 * (h + 1)])
        assert not p[..., 64 * h + 40:64 * (h + 1)].any()
    assert torch.equal(cut_heads(p, 3, 40), t)


@pytest.mark.parametrize("hd", WIDTHS)
def test_qkv_projection_padding_is_exact(hd):
    """Kernel A's padded operands give the plain version's o and v on
    their first hd channels of each head and zeros on the rest."""
    heads = 2
    x, w, b = _t(*_qkv_inputs(3, 20, heads * hd, seed=hd))
    hdp = padded_head_dim(hd)
    xp, wp, bp = pad_qkv_projection(x, w, b, heads, hdp)
    assert xp.shape == (3, 20, heads * hdp) and wp.shape == (heads * hdp,
                                                             3 * heads * hdp)
    o, v = area_attention_qkv_fused_plain(xp, wp, bp, heads, hd ** -0.5)
    ro, rv = area_attention_qkv_fused_plain(x, w, b, heads)
    _close(cut_heads(o, heads, hd), ro.numpy(), atol=1e-6)
    _close(cut_heads(v, heads, hd), rv.numpy(), atol=1e-6)
    assert not (o - pad_heads(cut_heads(o, heads, hd), heads, hdp)).any()


@pytest.mark.parametrize("hd", WIDTHS)
def test_kernel_a_at_any_head_width_matches_pallas(hd):
    heads = 2
    x, w, b = _qkv_inputs(3, 20, heads * hd, seed=hd + 1)
    jo, jv = jax_qkv_fused(jnp.asarray(x), jnp.asarray(w),
                           jnp.asarray(b[None]), heads, interpret=True)
    o, v = area_attention_qkv_fused(*_t(x, w, b), heads)
    _close(o, jo, atol=ATOL)
    _close(v, jv, atol=ATOL)


@pytest.mark.parametrize("hd", WIDTHS)
def test_kernel_c_at_any_head_width_matches_pallas(hd):
    heads = 2
    rng = np.random.default_rng(hd + 2)
    q, k, v = (rng.normal(size=(3, 20, heads * hd)).astype(np.float32)
               for _ in range(3))
    want = jax_fused(*map(jnp.asarray, (q, k, v)), heads)
    _close(area_attention_fused(*_t(q, k, v), heads), want, atol=ATOL)
    single = jax_single(*map(jnp.asarray, (q, k, v)))
    _close(area_attention(*_t(q, k, v)), single, atol=ATOL)


def test_gradients_at_width_48_match_jax_vjp():
    """Kernels A and C at two heads of 48: the padding in the forward, the
    backward over the unpadded operands, against `jax.vjp` of the Pallas
    kernels."""
    heads, hd = 2, 48
    x, w, b = _qkv_inputs(2, 17, heads * hd, seed=48)
    rng = np.random.default_rng(49)
    do, dv = (rng.normal(size=x.shape).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda x, w, b: jax_qkv_fused(x, w, b, heads,
                                                   interpret=True),
                     *map(jnp.asarray, (x, w, b[None])))
    want = vjp((jnp.asarray(do), jnp.asarray(dv)))
    tx, tw, tb = (t.requires_grad_() for t in _t(x, w, b))
    got = torch.autograd.grad(area_attention_qkv_fused(tx, tw, tb, heads),
                              (tx, tw, tb), _t(do, dv))
    for a, bw, name in zip(got, want, "xwb"):
        np.testing.assert_allclose(a.numpy(), np.asarray(bw).reshape(a.shape),
                                   atol=1e-4, rtol=0, err_msg=f"d{name}")
    q, k, v = (rng.normal(size=x.shape).astype(np.float32) for _ in range(3))
    _, vjp = jax.vjp(lambda q, k, v: jax_fused(q, k, v, heads),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    got = torch.autograd.grad(area_attention_fused(tq, tk, tv, heads),
                              (tq, tk, tv), torch.from_numpy(do))
    for a, bw, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(bw), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


def test_a_64_wide_head_takes_the_streamed_path():
    """A 64-wide head (or one padded to 64) is planned as a 32-wide one is:
    at bands of 64 tokens or fewer the short path, past them the streamed
    path, in both kernels and both types; a streamed CTA of 64 query rows
    in bf16 and 32 in f32."""
    for dtype, projection in itertools.product(
            (torch.float32, torch.bfloat16), (True, False)):
        for hd in (32, 64):
            assert attention_plan(8, 25, 128, dtype, projection,
                                  hd=hd).path == "short"
            assert attention_plan(8, 64, 128, dtype, projection,
                                  hd=hd).path == "short"
        assert attention_plan(8, 100, 128, dtype, projection, hd=64).streamed
    assert attention_plan(8, 400, 128, torch.bfloat16, hd=64).rows == 64
    assert attention_plan(8, 400, 128, torch.float32, hd=64).rows == 32


def _a2c2f_weights(rng, cin, c_, c2, n_stages, hid=None):
    hid = 2 * c_ if hid is None else hid
    mk = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)
    ws = [mk(cin, c_), mk(c_)]
    for _ in range(2 * n_stages):
        ws += [mk(c_, 3 * c_), mk(3 * c_), mk(7, 7, c_), mk(c_),
               mk(c_, c_), mk(c_), mk(c_, hid), mk(hid),
               mk(hid, c_), mk(c_)]
    return ws + [mk((n_stages + 1) * c_, c2), mk(c2)]


@pytest.mark.parametrize("c2,heads", [(32, 1), (96, 1), (160, 2)])
def test_a2c2f_plain_on_the_padded_fold_matches_pallas(c2, heads):
    """A2C2f blocks of c_ 16 (one head of 16, padded to 32), 48 (one of 48,
    padded to 64) and 80 (two of 40, padded to 64): the plain version over
    `A2C2f.folded_weights` (the fold pads qkv's columns, the pe taps and
    proj's rows) against the JAX module's mega route, the Pallas kernel in
    interpret mode over unpadded weights, within 2e-5."""
    c_ = c2 // 2
    x = np.random.default_rng(c2).normal(0, 0.5, (1, 20, 20, c2))
    x = x.astype(np.float32)
    jmod = jattn.A2C2f(c2=c2, n=1, a2=True, area=1, use_pallas=True,
                       mega_kernel=True)
    v = _init(jmod, jnp.asarray(x), seed=c2)
    port = _load(attention.A2C2f(c2, c2, n=1, a2=True, area=1,
                                 mega_kernel=True), v)
    assert port.num_heads == heads
    hdp = padded_head_dim(c_ // heads)
    fold = port.folded_weights(torch.float32)
    assert fold[2].shape == (c_, 3 * heads * hdp)
    assert fold[4].shape == (7, 7, heads * hdp)
    assert fold[6].shape == (heads * hdp, c_)
    with torch.no_grad():
        got = a2c2f_fused_plain(torch.from_numpy(x), fold, 1, 1, heads)
    _close(got, jmod.apply(v, jnp.asarray(x), train=False), atol=2e-5)


def test_a2c2f_at_five_stages_matches_pallas():
    """n = 5 (10 ABlocks; the kernel once held at most 8): the wrapper's
    plain version on the CPU against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.5, (1, 8, 8, 32)).astype(np.float32)
    ws = _a2c2f_weights(rng, 32, 32, 32, 5)
    jw, tw = _cast(ws, jnp.float32, torch.float32)
    got = a2c2f_fused(torch.from_numpy(x), tw, 5, 1, 1)
    _close(got, jax_a2c2f(jnp.asarray(x), jw, 5, 1, 1, interpret=True),
           atol=2e-5)


@pytest.fixture(scope="module")
def module_48():
    """A2C2f(96, 96): c_ 48 in one head of 48, JAX variables and the port's
    mega module over them."""
    x = np.random.default_rng(6).normal(0, 0.5, (1, 20, 20, 96))
    x = x.astype(np.float32)
    jmod = jattn.A2C2f(c2=96, n=1, a2=True, area=1)
    v = _init(jmod, jnp.asarray(x), seed=6)
    mega = _load(attention.A2C2f(96, 96, n=1, a2=True, area=1,
                                 mega_kernel=True), v)
    return x, v, mega


def test_module_at_c_48_matches_the_jax_module(module_48):
    """The port's A2C2f at one head of 48, its fold padded to 64: the mega
    route (the plain version over the padded fold on the CPU) against the
    JAX module's mega route (the Pallas kernel over unpadded weights) and
    its staged modules (kernel A at width 48, padded in the wrapper)
    against the JAX staged module, within 2e-5."""
    x, v, mega = module_48
    assert mega.num_heads == 1
    ws = mega.folded_weights(torch.float32)
    assert ws[2].shape == (48, 192) and ws[6].shape == (64, 48)
    jmega = jattn.A2C2f(c2=96, n=1, a2=True, area=1, use_pallas=True,
                        mega_kernel=True)
    want = jmega.apply(v, jnp.asarray(x), train=False)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = mega(_nchw(x))
        mega.mega_kernel = False
        staged = mega(_nchw(x))
        mega.mega_kernel = True
    _close(got.permute(0, 2, 3, 1), want, atol=2e-5)
    jstaged = jattn.A2C2f(c2=96, n=1, a2=True, area=1, use_pallas=True)
    _close(staged.permute(0, 2, 3, 1),
           jstaged.apply(v, jnp.asarray(x), train=False), atol=2e-5)


@pytest.mark.parametrize("cin,c_,hid,c2", [(3, 48, 38, 45), (24, 18, 36, 45),
                                           (32, 64, 128, 64)])
def test_f32_widths_are_padded_to_fours_exactly(cin, c_, hid, c2):
    """`pad_f32_widths` makes cin, c_, the MLP and c2 multiples of 4 (the
    f32 kernel's 16-byte rows) without changing a value; `_kernel_weights`
    pads the heads too and packs each GEMM weight panel-major for the
    kernel's bulk copies."""
    rng = np.random.default_rng(cin + c_)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 8, 8, cin)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _a2c2f_weights(rng, cin, c_, c2, 2,
                                                      hid)]
    xp, wp = pad_f32_widths(x, ws, 2)
    assert xp.shape[-1] % 4 == 0
    assert all(k % 4 == 0 for k in (wp[0].shape[1], wp[8].shape[1],
                                    wp[-2].shape[1]))
    want = a2c2f_fused_plain(x, ws, 2, 4, 1)
    _close(a2c2f_fused_plain(xp, wp, 2, 4, 1)[..., :c2], want.numpy(),
           atol=1e-6)
    xk, wk, dims = _kernel_weights(x, ws, 2, 1, tile=32)
    hd = padded_head_dim(c_)
    assert dims == (*map(_up4, (cin, c_)), hd, *map(_up4, (hid, c2)), hd)
    assert torch.equal(xk[..., :cin], x) and not xk[..., cin:].any()
    # each GEMM weight packed [panels][ceil32(K)][128]: panel p of the
    # padded weight, zero past it
    padded = pad_f32_widths(x, pad_a2c2f_heads(ws, 2, 1, hd), 2)[1]
    for i in (0, 2, 6, 8, 10, len(ws) - 2):
        k, n = padded[i].shape
        assert wk[i].shape == (-(-n // 128), -(-k // 32) * 32, 128)
        unpacked = wk[i].transpose(0, 1).reshape(wk[i].shape[1], -1)
        assert torch.equal(unpacked[:k, :n], padded[i])
        assert not unpacked[k:].any() and not unpacked[:, n:].any()


def _gated(mlp_ratio):
    """(hw, cin, c_, area, hid, depth) of yolov12 n-x's layers 6 and 8 at
    160^2-1280^2 (steps of 32) that the gate admits."""
    for scale, imgsz in itertools.product(YOLOV12_SCALES,
                                          range(160, 1281, 32)):
        depth, width, max_ch = YOLOV12_SCALES[scale]
        for c_in, c2, stride, area in ((512, 512, 16, 4),
                                       (1024, 1024, 32, 1)):
            cin = scale_channels(c_in, width, max_ch)
            c_ = scale_channels(c2, width, max_ch) // 2
            hw = imgsz // stride
            area_ = area if (hw * hw) % area == 0 else 1
            if a2c2f_mega_eligible(hw, hw, cin, c_, area_, max(1, c_ // 32)):
                yield hw, cin, c_, area_, int(c_ * mlp_ratio), \
                    scale_depth(4, depth)


@pytest.mark.parametrize("mlp_ratio", [2.0, 1.2])
def test_f32_plan_fits_every_gated_shape(mlp_ratio):
    """The f32 kernel's shared memory is a function of its token tile and
    head width only (no width of the block, no stage count): at heads of
    32 and 64 and every shape the gate admits for yolov12 n-x at
    160^2-1280^2, the tile `f32_tile` picks fits 232,448 bytes; so does the
    largest layout."""
    shapes = list(_gated(mlp_ratio))
    assert len(shapes) == 10
    assert max(f32_smem_bytes(t, hd) for t in F32_TILES
               for hd in KERNEL_HEAD_DIMS) == f32_smem_bytes(32, 64) \
        == 160_336 <= _SMEM_LIMIT == 232_448
    for (hw, cin, c_, area, hid, depth), hd in itertools.product(
            shapes, KERNEL_HEAD_DIMS):
        nb = hw * hw // area
        for batch in (1, 8):
            tile = f32_tile(batch, nb, area)
            assert tile in F32_TILES
            assert f32_smem_bytes(tile, hd) <= _SMEM_LIMIT


def test_the_f32_layout_constants_are_the_kernels():
    """`f32_smem_bytes` and `f32_panel` mirror a2c2f_f32.cu's `F32Layout`:
    its threads, K rows a stage, ring stages, keys an attention tile,
    attention stages and probability stride."""
    csrc = Path(a2c2f_module.__file__).parent.parent / "csrc"
    # the GEMM's threads, K rows a stage and ring stages live in the GEMM
    # stream's header, which kernel A's f32 projection shares
    text = ((csrc / "a2c2f_f32.cu").read_text()
            + (csrc / "gemm_f32.cuh").read_text())

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert (a2c2f_module._F32_THREADS, a2c2f_module._KS,
            a2c2f_module._STAGES, a2c2f_module._KB_ATT,
            a2c2f_module._ATT_STAGES, a2c2f_module._LDP_ATT) == tuple(
        constant(n) for n in ("GEMM_THREADS", "KS_F32", "GEMM_STAGES",
                              "KB_ATT", "ATT_STAGES", "LDP_ATT"))
    assert "constexpr int F32_THREADS = GEMM_THREADS;" in text
    assert "constexpr int STAGES = GEMM_STAGES;" in text
    assert [f32_panel(t) for t in F32_TILES] == [64, 128]


def test_f32_tile_puts_the_fewest_rows_on_an_sm():
    """Batch 8 at 640^2: yolov12l's layer 8 (8 bands of 400 tokens) takes
    32-token tiles (104 tiles on 132 SMs, against 56 of 64 tokens on 56
    SMs); yolov12n's layer 6 (32 bands of 400) takes 64 (224 tiles, two on
    the busiest SM, against four of 32); a tie takes 64 (layer 8 at 896^2:
    104 tiles of 64 or 200 of 32)."""
    assert f32_tile(8, 400, 1) == 32
    assert f32_tile(8, 400, 4) == 64
    assert f32_tile(8, 784, 1) == 64


def test_bf16_layout_of_padded_heads_fits():
    """bf16 at a head of 64 (A2C2f(96, 96)'s padded fold, and heads 64 wide
    at yolov12n's layer 8 width) fits a block with its weight ring and
    staged stencil rows."""
    for c_, ca in ((48, 64), (128, 128), (64, 128)):     # 20 x 20 images
        nbytes, ring, staged, _ = bf16_plan(c_, ca, 2 * c_, 64, 20)
        assert nbytes <= _SMEM_LIMIT and ring >= 2 and staged
