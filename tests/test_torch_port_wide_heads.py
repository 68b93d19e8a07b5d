"""PyTorch port: heads wider than 64 channels.

The JAX package admits any head width: `pallas_band_eligible` asks only N %
16 == 0 and C % heads == 0, and `a2c2f_mega_eligible` admits heads up to 256
wide. On the card the port pads a head wider than 64 with zero channels to
the next multiple of 64 (`padded_head_dim`) and runs kernel C's blocked form
(`attention.blocked_plan`, path "blocked", at any N): a CTA a (head,
64-channel output block, query tile), its scores summed over the head's
64-channel blocks, its shared memory the same at every width; kernel A runs
its wide form's projection, then that attention; both `a2c2f` kernels
attend a (head, 64-channel output block) pair at a time the same way. What
the CPU can check:

  * the plans: heads of 65-928 take the blocked path in both types and
    both kernels, in one layout whatever the width, within a block; the
    bytes and constants against the CUDA source; every shape the JAX gate
    admits at heads of 65-256 has an `a2c2f` plan in both types;
  * a torch emulation of the blocked computation (zero-padded heads, scores
    summed over 64-channel blocks, each output block its own online softmax
    over key tiles of 128 (bf16 form) and 64 (f32 form)) against the Pallas
    kernels in interpret mode at heads of 96, 128 and 256 and bands of 25
    and 100, within 1e-5; through `a2c2f_fused_plain(..., attention=...)`
    against the JAX `a2c2f_fused` at c_ 96 in one head and 256 in two,
    within 2e-5;
  * the module: AAttn(256, 2, 4) and AAttn(256, 1, 4) in eval and train mode
    against the JAX module (Pallas in interpret mode), weights carried by
    `state_dict_from_jax`: outputs within 1e-5, gradients within 1e-4.
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
from yolou_tpu.ops.pallas_a2c2f import a2c2f_mega_eligible as jax_gate
from yolou_tpu.ops.pallas_attn import area_attention as jax_single
from yolou_tpu.ops.pallas_attn import area_attention_fused as jax_fused
from yolou_tpu.ops.pallas_attn import area_attention_qkv_fused as jax_qkv
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels.a2c2f import (F32_TILES, a2c2f_fused_plain,
                                           a2c2f_mega_eligible, bf16_layout,
                                           bf16_plan, f32_smem_bytes,
                                           pad_a2c2f_heads)
from yolou_tpu_torch.kernels.attention import (
    _SMEM_LIMIT, BLOCK, area_attention, area_attention_fused,
    area_attention_qkv_fused, attention_plan, cut_heads, kv_projection_smem,
    pad_heads, padded_head_dim)
from yolou_tpu_torch.nn.attention import AAttn, aattn_qkv_permutation
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_port_a2c2f import _cast, _weights
from .test_torch_port_layers import _init, _nchw
from .torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(attn.__file__).parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
HEAD_WIDTHS = (65, 96, 128, 192, 256, 512, 928)
BANDS = [(1, 1), (3, 25), (8, 64), (2, 65), (4, 100), (8, 400), (2, 1937)]
KEYS = {"bf16": 128, "f32": 64}     # key tiles of the two forms
LOG2E = 1.4426950408889634


# ------------------------------------------------------------- the plans

@pytest.mark.parametrize("dtype", [F32, BF16], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("projection", [True, False], ids=["A", "C"])
def test_wide_heads_take_the_blocked_path_in_one_layout(projection, dtype):
    """Heads of 65 to 928 channels (padded to the next multiple of 64) take
    the blocked path at every band length, kernel A in two launches, C in
    one, at 64 query rows a CTA in bf16 and 32 in f32; kernel C's shared
    memory is one number at every width, kernel A's the larger of it and
    its projection's (which rings over C), all within a block; heads of 64
    and narrower keep their paths."""
    smem = set()
    for hd in HEAD_WIDTHS:
        hdp = padded_head_dim(hd)
        assert hdp % BLOCK == 0 and hdp - BLOCK < hd <= hdp
        for heads, (g, n) in itertools.product((1, 2, 3), BANDS):
            c = heads * hdp
            plan = attention_plan(g, n, c, dtype, projection, hd=hdp)
            assert plan.path == "blocked" and plan.streamed
            assert plan.launches == (2 if projection else 1)
            assert plan.rows == (64 if dtype == BF16 else 32)
            assert plan.smem <= _SMEM_LIMIT
            if projection:
                proj = (kv_projection_smem(c) if dtype == BF16
                        else attn._KV_F32_SMEM)
                assert plan.smem == max(attn._BLOCKED_SMEM[dtype], proj)
            else:
                smem.add(plan.smem)
    assert projection or smem == {attn._BLOCKED_SMEM[dtype]}
    for hd in (16, 32, 48, 64):
        assert attention_plan(4, 400, 2 * padded_head_dim(hd), dtype,
                              projection, hd=padded_head_dim(hd)).path \
            != "blocked"


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def test_the_blocked_bytes_are_the_kernels():
    """`_BLOCKED_SMEM` and `_BLOCKED_ROWS` are band_attention.cu's
    `blocked_smem` and row counts over its constants: bf16 three units of a
    64-row q block and a 128-key k block, two v blocks, a full and an empty
    barrier a stage; f32 (the cluster form, one cluster up to 1024
    channels) a resident 32-row q block, two 64-key k blocks and two v
    blocks, two buffers of a key tile's partial scores and the
    probabilities, a full and an empty barrier a stage and q's."""
    text = (CSRC / "band_attention.cu").read_text()
    blk, units, vst = (_constant(text, n) for n in ("BLK", "UNITS_MMA",
                                                    "V_STAGES"))
    wg, kb, kf, ldp, rows, kst, cvst = (_constant(text, n) for n in (
        "WG_ROWS", "KB_MMA", "KB_F32", "LDP", "BLOCKED_F32_ROWS",
        "K_STAGES", "CV_STAGES"))
    assert blk == BLOCK == 64
    assert attn._BLOCKED_SMEM[BF16] == (
        1024 + 2 * (units * (wg + kb) * blk + vst * kb * blk)
        + 8 * 2 * (units + vst)) == 107_600
    assert attn._BLOCKED_SMEM[F32] == (
        1024 + 4 * (rows * blk + (kst + cvst) * kf * blk + 2 * rows * kf
                    + rows * ldp)
        + 8 * (2 * (kst + cvst) + 1)) == 100_936
    assert attn._BLOCKED_ROWS == {BF16: wg, F32: rows}
    # two CTAs an SM, as the 64-wide forms
    assert 2 * (attn._BLOCKED_SMEM[BF16] + 1024) <= 228 * 1024
    assert 2 * (attn._BLOCKED_SMEM[F32] + 1024) <= 228 * 1024
    assert "constexpr int UNIT = QB + KT;" in text
    assert "const dim3 grid(heads * (hdp / BLK), G, (N + rows - 1) / rows);" \
        in text
    assert ("cfg.gridDim = dim3(heads * cluster_groups(nbk) * cs, G,"
            in text)
    assert ("if (C / heads > 64)\n    return launch_blocked(q, k, v, o, G, "
            "N, heads, C / heads," in text)


def _wide_admitted():
    """(c_, heads, hdp, widths) of every A2C2f width the JAX gate admits at
    heads wider than 64 (c_ up to 256 = 1600 * 64 / 400), with the widths of
    the images of 400 tokens or more it admits (H the fewest rows that make
    400); the port's gate gives the same answers."""
    for c_, heads in itertools.product(range(65, 257), (1, 2, 3)):
        if c_ % heads or c_ // heads <= 64:
            continue
        widths = []
        for w in (1, 7, 16, 20, 25, 40, 80, 100, 200, 400):
            args = (-(-400 // w), w, 512, c_, 1, heads)
            assert a2c2f_mega_eligible(*args) == jax_gate(*args)
            if jax_gate(*args):
                widths.append(w)
        if widths:
            yield c_, heads, padded_head_dim(c_ // heads), widths


@pytest.mark.parametrize("mlp_ratio", [1.2, 2.0, 4.0, 8.0])
def test_every_admitted_wide_head_has_an_a2c2f_plan(mlp_ratio):
    """bf16: a plan within a block at every gate-admitted c_ with heads of
    65-256 (padded to 128, 192 or 256), every image width and MLP, the same
    plan as heads of 64 at that attention width (the blocked form lays out
    as a head of 64); f32: one layout at every such width, within a block."""
    seen = 0
    for c_, heads, hdp, widths in _wide_admitted():
        ca, hid = heads * hdp, -(-int(c_ * mlp_ratio) // 16) * 16
        for width in widths:
            plan = bf16_plan(-(-c_ // 8) * 8, ca, hid, hdp, width)
            assert plan is not None and plan.bytes <= _SMEM_LIMIT, (c_, heads)
            assert plan == bf16_plan(-(-c_ // 8) * 8, ca, hid, 64, width)
            seen += 1
        for tile in F32_TILES:
            assert f32_smem_bytes(tile, hdp) == f32_smem_bytes(tile, 128) \
                <= _SMEM_LIMIT
    assert seen > 300
    assert max(f32_smem_bytes(t, 128) for t in F32_TILES) == \
        f32_smem_bytes(32, 128) == 1024 + 4 * (2 * (2 * 2 * 64 + 32) * 64
                                               + 2 * 32 * 76) + 8 * 10
    assert bf16_layout(256, 384, 320, 128, 2, 20, False, False) == \
        bf16_layout(256, 384, 320, 64, 2, 20, False, False)


def test_the_a2c2f_layouts_of_wide_heads_are_the_kernels():
    """The f32 kernel's blocked layout (a stage: the key groups' k and v
    tiles of a 64-channel block and q's block of the tile's rows, no q tile
    of its own) and the bf16 `layout` of a head of 64 for wider ones are the
    CUDA source's; both entries take heads wider than 64 in multiples of
    64."""
    f32 = (CSRC / "a2c2f_f32.cu").read_text()
    bf16 = (CSRC / "a2c2f_bf16.cu").read_text()
    cuh = (CSRC / "a2c2f.cuh").read_text()
    assert "static constexpr int Q_TILE = HD_ == BLOCKED ? TM * HB : 0;" in f32
    assert "static constexpr int KV_STAGE = 2 * NG * KV_TILE + Q_TILE;" in f32
    assert "hd = hd == 32 ? 32 : 64;" in bf16
    assert "(ca / heads != 32 && ca / heads % 64)" in cuh
    assert "constexpr int BLOCKED = 0;" in cuh


# ---------------------------------------------- the blocked computation

def blocked_heads(keys, dtype=F32):
    """The blocked form's attention over (G, heads, N, hdp) f32 (heads
    padded to a multiple of 64): per 64-channel output block its own online
    softmax over key tiles of `keys` in log2 units against a running
    maximum, the scores of each tile summed over the head's 64-channel
    blocks in order; the probabilities rounded to `dtype` for p.v, their
    sum unrounded; the division after p.v. A drop-in for
    `band_attention_plain` (scale the true head width's)."""

    def attend(q, k, v, dtype_=dtype, scale=None):
        n, hdp = q.shape[-2:]
        sl2 = (hdp ** -0.5 if scale is None else scale) * LOG2E
        out = torch.empty_like(q)
        for ob in range(0, hdp, BLOCK):
            m = torch.full(q.shape[:-1] + (1,), -torch.inf)
            l = torch.zeros_like(m)
            acc = torch.zeros(q.shape[:-1] + (BLOCK,))
            for k0 in range(0, n, keys):
                s = 0
                for j in range(0, hdp, BLOCK):
                    s = s + q[..., j:j + BLOCK] @ k[..., k0:k0 + keys,
                                                    j:j + BLOCK].transpose(
                                                        -1, -2)
                m_new = torch.maximum(m, s.amax(-1, keepdim=True))
                p = torch.exp2(s * sl2 - m_new * sl2)
                c = torch.exp2((m - m_new) * sl2)
                l = l * c + p.sum(-1, keepdim=True)
                acc = acc * c + (p.to(dtype_).float()
                                 @ v[..., k0:k0 + keys, ob:ob + BLOCK])
                m = m_new
            out[..., ob:ob + BLOCK] = acc / l
        return out

    return attend


def blocked_attention(q, k, v, heads, keys):
    """Kernel C's blocked form on (G, N, C) f32 with heads of any width:
    zero-padded to `padded_head_dim`, `blocked_heads`, cut back."""
    g, n, c = q.shape
    hd = c // heads
    hdp = padded_head_dim(hd)

    def split(t):
        return pad_heads(t, heads, hdp).reshape(g, n, heads, hdp).transpose(
            1, 2)

    o = blocked_heads(keys)(*(split(t) for t in (q, k, v)), scale=hd ** -0.5)
    return cut_heads(o.transpose(1, 2).reshape(g, n, heads * hdp), heads, hd)


def _arrays(shape, seed, count=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(count)]


@pytest.mark.parametrize("n", [25, 100])
@pytest.mark.parametrize("hd", [96, 128, 256])
def test_blocked_kernel_c_matches_pallas(hd, n):
    """Kernel C (two heads) and its one-head entry: the blocked form's
    emulation at both key tiles, and the port's entries on the CPU, against
    the Pallas `area_attention_fused` and `area_attention` in interpret
    mode, within 1e-5."""
    q, k, v = _arrays((2, n, 2 * hd), seed=hd + n)
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), 2,
                                interpret=True))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = [area_attention_fused(tq, tk, tv, 2)]
    got += [blocked_attention(tq, tk, tv, 2, keys) for keys in KEYS.values()]
    for o in got:
        np.testing.assert_allclose(o.numpy(), want, rtol=0, atol=1e-5)
    q1, k1, v1 = (t[..., :hd] for t in (q, k, v))
    want1 = np.asarray(jax_single(*map(jnp.asarray, (q1, k1, v1)),
                                  interpret=True))
    t1 = [torch.from_numpy(np.ascontiguousarray(t)) for t in (q1, k1, v1)]
    got1 = [area_attention(*t1)]
    got1 += [blocked_attention(*t1, 1, keys) for keys in KEYS.values()]
    for o in got1:
        np.testing.assert_allclose(o.numpy(), want1, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.05


@pytest.mark.parametrize("n", [25, 100])
@pytest.mark.parametrize("hd", [96, 128, 256])
def test_blocked_kernel_a_matches_pallas(hd, n):
    """Kernel A at two heads: the wide form's projection (q | k | v = x.w + b
    in f32) then the blocked attention's emulation, and the port's entry on
    the CPU, against the Pallas `area_attention_qkv_fused` in interpret mode,
    o and v within 1e-5."""
    c = 2 * hd
    rng = np.random.default_rng(hd * n)
    x = rng.normal(size=(2, n, c)).astype(np.float32)
    w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c)).astype(np.float32)
    b = rng.normal(0, 0.1, (3 * c,)).astype(np.float32)
    jo, jv = (np.asarray(t) for t in jax_qkv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)[None], 2,
        interpret=True))
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    o, v = area_attention_qkv_fused(tx, tw, tb, 2)
    qkv = torch.matmul(tx, tw) + tb
    got = [(o, v)] + [(blocked_attention(*qkv.split(c, -1), 2, keys),
                       qkv[..., 2 * c:]) for keys in KEYS.values()]
    for go, gv in got:
        np.testing.assert_allclose(go.numpy(), jo, rtol=0, atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), jv, rtol=0, atol=1e-5)
    assert np.abs(jo).max() > 0.05


@pytest.fixture(scope="module")
def a2c2f_cases():
    """(name -> x, torch weights, args, the Pallas kernel's output in
    interpret mode): one-head c_ 96 (padded to 128) and two heads of 128 at
    c_ 256, both over 12 x 12 images in one band of 144 keys (two key tiles
    of 128, three of 64), f32."""
    out = {}
    for name, cin, c_, c2, heads in (("c_96 h1", 32, 96, 64, 1),
                                     ("c_256 h2", 32, 256, 64, 2)):
        rng = np.random.default_rng(c_ + heads)
        x = rng.normal(0, 0.5, (1, 12, 12, cin)).astype(np.float32)
        ws = _weights(rng, cin, c_, c2, 1)
        jw, tw = _cast(ws, jnp.float32, F32)
        want = jax_a2c2f(jnp.asarray(x), jw, 1, 1, heads, interpret=True)
        out[name] = (torch.from_numpy(x), tw, (1, 1, heads), np.asarray(want))
    return out


@pytest.mark.parametrize("form", list(KEYS))
@pytest.mark.parametrize("name", ["c_96 h1", "c_256 h2"])
def test_blocked_a2c2f_matches_pallas(a2c2f_cases, name, form):
    """The whole block with the blocked attention (over the weights padded
    as the kernels take them, the true scale kept) and the port's plain
    version, against the JAX `a2c2f_fused` (interpret mode), within 2e-5."""
    x, tw, args, want = a2c2f_cases[name]
    c_, heads = tw[0].shape[1], args[2]
    hdp = padded_head_dim(c_ // heads)
    kw = tw if hdp == c_ // heads else pad_a2c2f_heads(tw, 1, heads, hdp)
    assert kw[2].shape[1] == 3 * heads * hdp
    got = a2c2f_fused_plain(x, kw, *args, attention=blocked_heads(KEYS[form]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    plain = a2c2f_fused_plain(x, tw, *args)
    np.testing.assert_allclose(plain.numpy(), want, rtol=0, atol=2e-5)
    assert np.abs(want).max() > 0.05


# ------------------------------------------------------------- the module

def aattn_state_dict(variables, heads):
    """A bare AAttn's JAX variables (params, or their gradients, and batch
    statistics) as the port module's state_dict: `state_dict_from_jax` over
    them as an A2C2f block's `attn` (where the converter finds qkv convs; it
    permutes their channels at A2C2f's head rule, heads of 32 at C = 256),
    then the qkv channels moved to this module's head width (C / heads)."""
    sd = state_dict_from_jax({coll: {"attn": tree}
                              for coll, tree in variables.items()})
    c3 = variables["params"]["qkv"]["conv"]["kernel"].shape[-1]
    move = torch.from_numpy(aattn_qkv_permutation(c3, 32)[np.argsort(
        aattn_qkv_permutation(c3, c3 // 3 // heads))])
    return {k[len("attn."):]: t[move] if k.startswith("attn.qkv.") and t.ndim
            else t for k, t in sd.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("heads", [2, 1])
def test_aattn_with_wide_heads_matches_jax(heads, train):
    """AAttn(256, heads, area 4) (heads of 128 or one of 256) at (2, 8, 8,
    256), bands of 16: the port on the CPU against the JAX module with
    `use_pallas` (the Pallas kernels in interpret mode), weights carried by
    `state_dict_from_jax`; outputs within 1e-5, and in train mode (batch
    statistics) the gradients of the input and of every parameter within
    1e-4."""
    x = np.random.default_rng(heads).normal(size=(2, 8, 8, 256)).astype(
        np.float32)
    jmod = jattn.AAttn(256, heads, area=4, use_pallas=True)
    v = _init(jmod, jnp.asarray(x), seed=heads)
    mod = AAttn(256, heads, area=4)
    missing, unexpected = mod.load_state_dict(aattn_state_dict(v, heads),
                                              strict=False)
    assert not unexpected and not missing
    if not train:
        ref = jax.jit(jmod.apply)(v, jnp.asarray(x))
        with torch.no_grad():
            out = mod.eval()(_nchw(x))
        np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(ref), rtol=0, atol=1e-5)
        assert np.abs(np.asarray(ref)).max() > 0.05
        return
    cot = np.random.default_rng(heads + 9).normal(size=x.shape).astype(
        np.float32)

    def loss(params, xj):
        out, _ = jmod.apply({**v, "params": params}, xj, train=True,
                            mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(v["params"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    out = mod.train()(xt)
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(ref), rtol=0, atol=1e-5)
    (out * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), rtol=0, atol=1e-4)
    want = aattn_state_dict({**v, "params": gp}, heads)
    grads = dict(mod.named_parameters())
    assert len(grads) == 9 and set(grads) <= set(want)
    for k, p in grads.items():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-4, err_msg=k)
