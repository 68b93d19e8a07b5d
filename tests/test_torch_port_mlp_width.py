"""PyTorch port: the whole-A2C2f kernel at any MLP width and within shared
memory at every shape the routing gate admits.

The JAX Pallas kernel takes the MLP's hidden width h from its weights
(`pallas_a2c2f.py`); the port's kernel does too. On the CPU the wrapper
runs `a2c2f_fused_plain`, held here at mlp_ratio 1.2 (h = 38 at c_ = 32)
against the Pallas kernel in interpret mode and the JAX plain composition,
and the module's mega route against the JAX module's. The bf16 fold pads h
to a multiple of 16 for the tensor cores (zero columns of mlp1, zero rows of
mlp2), which must not change a value. The layout plan (`f32_tile` and
`f32_smem_bytes`, the bf16 `bf16_plan`) fits every shape
`a2c2f_mega_eligible` admits over yolov12 n-x at 160^2-1280^2, at mlp_ratio
2 and 1.2.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.nn import attention as jattn
from yolou_tpu.ops.pallas_a2c2f import a2c2f_fused as jax_fused
from yolou_tpu.ops.pallas_a2c2f import a2c2f_reference
from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels.a2c2f import (_SMEM_LIMIT, a2c2f_fused,
                                           a2c2f_fused_plain,
                                           a2c2f_mega_eligible, bf16_plan,
                                           f32_smem_bytes, f32_tile)
from yolou_tpu_torch.models.specs import (YOLOV12_SCALES, scale_channels,
                                          scale_depth)
from yolou_tpu_torch.nn import attention

from .test_torch_port_a2c2f import _cast
from .test_torch_port_layers import _close, _init, _load, _nchw
from .torch_threads import one_torch_thread  # noqa: F401

MLP = 1.2


def _weights(rng, cin, c_, c2, n_stages, hid):
    mk = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)
    ws = [mk(cin, c_), mk(c_)]
    for _ in range(2 * n_stages):
        ws += [mk(c_, 3 * c_), mk(3 * c_), mk(7, 7, c_), mk(c_),
               mk(c_, c_), mk(c_), mk(c_, hid), mk(hid),
               mk(hid, c_), mk(c_)]
    return ws + [mk((n_stages + 1) * c_, c2), mk(c2)]


CASES = [((2, 16, 16, 32), dict(c_=32, c2=64, n_stages=2, area=4, heads=1)),
         ((1, 8, 8, 24), dict(c_=64, c2=48, n_stages=1, area=1, heads=2))]


@pytest.mark.parametrize("shape,cfg,bf16", [(*CASES[0], False),
                                            (*CASES[1], True)])
def test_plain_at_mlp_ratio_1_2_matches_pallas_and_reference(shape, cfg,
                                                             bf16):
    """f32 within 2e-5 of the Pallas kernel (interpret mode) and of the JAX
    plain composition; bf16 (at the smaller shape, whose interpret-mode run
    is the quicker) within 2e-2 of the Pallas kernel, the bounds of
    `test_torch_port_a2c2f.py` at mlp_ratio 2."""
    rng = np.random.default_rng(4)
    hid = int(cfg["c_"] * MLP)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    ws = _weights(rng, shape[-1], cfg["c_"], cfg["c2"], cfg["n_stages"], hid)
    args = (cfg["n_stages"], cfg["area"], cfg["heads"])
    jw, tw = _cast(ws, jnp.float32, torch.float32)
    got = a2c2f_fused(torch.from_numpy(x), tw, *args)     # plain on the CPU
    _close(got, jax_fused(jnp.asarray(x), jw, *args, interpret=True),
           atol=2e-5)
    _close(got, a2c2f_reference(jnp.asarray(x), jw, *args), atol=2e-5)
    if not bf16:
        return
    jw, tw = _cast(ws, jnp.bfloat16, torch.bfloat16)
    got = a2c2f_fused(torch.from_numpy(x).to(torch.bfloat16), tw, *args)
    kern = jax_fused(jnp.asarray(x).astype(jnp.bfloat16), jw, *args,
                     interpret=True)
    _close(got.float(), kern.astype(jnp.float32), atol=2e-2)


@pytest.fixture(scope="module")
def module_pair():
    """The smallest eligible shape (2, 20, 20, 64) at mlp_ratio 1.2: JAX
    variables and the port's mega module over them."""
    x = np.random.default_rng(5).normal(0, 0.5, (2, 20, 20, 64))
    x = x.astype(np.float32)
    v = _init(jattn.A2C2f(c2=64, n=1, a2=True, area=1, mlp_ratio=MLP),
              jnp.asarray(x), seed=5)
    mega = _load(attention.A2C2f(64, 64, n=1, a2=True, area=1, mlp_ratio=MLP,
                                 mega_kernel=True), v)
    return x, v, mega


def test_module_mega_route_at_mlp_ratio_1_2_matches_jax(module_pair,
                                                        monkeypatch):
    """The port's mega route (one call of the whole-block entry, h = 38)
    within 1e-5 of the JAX module's mega route in f32 (the Pallas kernel in
    interpret mode), and of the port's staged route."""
    x, v, mega = module_pair
    jmega = jattn.A2C2f(c2=64, n=1, a2=True, area=1, mlp_ratio=MLP,
                        use_pallas=True, mega_kernel=True)
    ref = jmega.apply(v, jnp.asarray(x), train=False)
    calls = []
    real = attention.a2c2f_fused
    monkeypatch.setattr(attention, "a2c2f_fused",
                        lambda *a: calls.append(a[1][8].shape) or real(*a))
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = mega(_nchw(x))
        mega.mega_kernel = False
        staged = mega(_nchw(x))
        mega.mega_kernel = True
    assert calls == [(32, 38)]                # mlp1's weight, h = 38
    _close(got.permute(0, 2, 3, 1), ref, atol=1e-5)
    _close(got, staged.numpy(), atol=1e-5)


def test_the_bf16_fold_pads_the_mlp_width_exactly(module_pair):
    """bf16: mlp1 (c_, 48) and its bias, mlp2 (48, c_), the 10 added
    columns / rows zero and the rest the f32 fold rounded; the plain version
    over the padded fold gives what it gives over the same weights cut back
    to h = 38. f32 keeps h."""
    x, _, mega = module_pair
    f32 = mega.folded_weights(torch.float32)
    bf16 = mega.folded_weights(torch.bfloat16)
    assert f32[8].shape == (32, 38) and f32[10].shape == (38, 32)
    for a in range(2):                         # the stage's two ABlocks
        i = 2 + 10 * a
        w1, b1, w2 = bf16[i + 6], bf16[i + 7], bf16[i + 8]
        assert w1.shape == (32, 48) and b1.shape == (48,)
        assert w2.shape == (48, 32) and w1.dtype == torch.bfloat16
        assert not w1[:, 38:].any() and not b1[38:].any()
        assert not w2[38:].any()
        assert torch.equal(w1[:, :38], f32[i + 6].to(torch.bfloat16))
        assert torch.equal(b1[:38], f32[i + 7])
        assert torch.equal(w2[:38], f32[i + 8].to(torch.bfloat16))
    cut = list(bf16)
    for a in range(2):
        i = 2 + 10 * a
        cut[i + 6] = bf16[i + 6][:, :38].contiguous()
        cut[i + 7] = bf16[i + 7][:38].contiguous()
        cut[i + 8] = bf16[i + 8][:38].contiguous()
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        padded = a2c2f_fused_plain(xt, bf16, 1, 1, 1)
        unpadded = a2c2f_fused_plain(xt, cut, 1, 1, 1)
    _close(padded.float(), unpadded.float().numpy(), atol=0)


def gated_shapes(mlp_ratio, graphs_only=False):
    """(H, W, cin, c_, area, heads, n_stages, hidden) of yolov12 n-x's
    layers 6 and 8 at 160^2-1280^2 (steps of 32) that the gate admits, and
    (unless `graphs_only`) of the gate's longest bands (c_ 32 and 64 at area
    1, cin 32 and 512, one and four stages: modules no yolov12 graph
    builds)."""
    out = []
    for scale, imgsz in itertools.product(YOLOV12_SCALES,
                                          range(160, 1281, 32)):
        depth, width, max_ch = YOLOV12_SCALES[scale]
        n_stages = scale_depth(4, depth)
        for c_in, c2, stride, area in ((512, 512, 16, 4),
                                       (1024, 1024, 32, 1)):
            cin = scale_channels(c_in, width, max_ch)
            c_ = scale_channels(c2, width, max_ch) // 2
            hw = imgsz // stride
            area_ = area if (hw * hw) % area == 0 else 1
            heads = max(1, c_ // 32)
            if a2c2f_mega_eligible(hw, hw, cin, c_, area_, heads):
                out.append((hw, hw, cin, c_, area_, heads, n_stages,
                            int(c_ * mlp_ratio)))
    if graphs_only:
        return out
    for hw, cin, c_, n_stages in itertools.product(
            range(20, 57, 4), (32, 512), (32, 64), (1, 4)):
        if a2c2f_mega_eligible(hw, hw, cin, c_, 1, c_ // 32):
            out.append((hw, hw, cin, c_, 1, c_ // 32, n_stages,
                        int(c_ * mlp_ratio)))
    return out


@pytest.mark.parametrize("mlp_ratio", [2.0, MLP])
def test_the_layout_plan_fits_every_shape_the_gate_admits(mlp_ratio):
    """f32: the register-tiled kernel's token tile of 64 or 32 fits at every
    shape (its shared memory depends on the tile and the head width only;
    batch 8: yolov12l's layer 8 at 640^2 takes 32 tokens, the rest 64).
    bf16 with h padded to 16: the wgmma kernel, which streams every band's
    keys and values, fits every shape at a weight ring of 2-4 stages with
    the stencil's v rows staged; yolov12n's layers 6 and 8 at 640^2 at the
    full 4."""
    shapes = gated_shapes(mlp_ratio)
    assert len(shapes) == 10 + 64
    tiles = {}
    for H, W, cin, c_, area, heads, n_stages, hid in shapes:
        nb = H * W // area
        tile = f32_tile(8, nb, area)
        assert f32_smem_bytes(tile) <= _SMEM_LIMIT, (H, W, cin, c_, n_stages)
        tiles[(H, cin, c_, n_stages)] = tile
    rings = {}
    for H, W, cin, c_, area, heads, n_stages, hid in shapes:
        pad = -(-hid // 16) * 16
        plan = bf16_plan(c_, c_, pad, 32, W)
        assert plan is not None, (H, cin, c_, n_stages)
        assert plan[0] <= _SMEM_LIMIT and plan[2], (H, cin, c_, n_stages)
        rings[(H, cin, c_, n_stages)] = plan[1]
    assert rings[(40, 128, 64, 2)] == rings[(20, 256, 128, 2)] == 4
    assert min(rings.values()) >= 2
    if mlp_ratio == 2.0:
        assert tiles[(20, 512, 256, 4)] == 32            # yolov12l L8 @640
        assert tiles[(28, 256, 128, 2)] == 64            # yolov12n L8 @896
        assert tiles[(40, 128, 64, 2)] == 64             # yolov12n L6 @640
        assert tiles[(40, 32, 64, 1)] == 64              # a band of 1600
        assert tiles[(56, 512, 32, 4)] == 64             # 3136
        # the f32 CTA of the old SIMT kernel at 16 tokens passed 227 KB here
        assert f32_smem_bytes(32) == 90_704 <= _SMEM_LIMIT
