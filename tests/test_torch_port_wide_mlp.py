"""PyTorch port: the bf16 whole-A2C2f kernel at any MLP width the gate
admits.

The gate (`a2c2f_mega_eligible`, as the JAX package's) admits any
`mlp_ratio`. The bf16 kernel keeps the MLP's hidden tile h, up64(hid) x 64
bf16, in shared memory where a layout with it fits a block; where none does
(mlp_ratio 3 and up at the widest c_), it keeps h in a (tokens, hid) scratch
in global memory instead: mlp1's epilogue stores the tile's rows there (the
same bf16 rounding point) and mlp2 reads them back as boxes riding with its
weight stages, as cv2 reads the ys concat. What the CPU can check:

  * the plan (`bf16_plan`): every gate-admitted c_ at mlp_ratio 1.2, 2, 3,
    4, 6 and 8, heads of 32 and 64, images 1 to 1600 tokens wide, fits a
    block; h leaves shared memory exactly where no layout with it fits (at
    yolov12's head rule and images 20, 40 and 80 wide: mlp_ratio 3 at c_ 216
    and 256, 3.5 and 4 at 216, 224 and 256, 6 from 136, 8 from 120); the
    f32 kernel's layout does not depend on the widths;
  * the plan's bytes against the CUDA source's layout;
  * the module: A2C2f(128, 128, mlp_ratio=4.0, mega_kernel=True) at 20^2,
    the smallest gate-admitted shape at c_ 64, against the JAX module's mega
    route (the Pallas kernel in interpret mode) and the port's staged route
    in f32, weights carried by `state_dict_from_jax`, within 2e-5.
"""

import itertools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.nn import attention as jattn
from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels import a2c2f as a2c2f_module
from yolou_tpu_torch.kernels.a2c2f import (_SMEM_LIMIT, a2c2f_mega_eligible,
                                           bf16_layout, bf16_plan,
                                           f32_smem_bytes)
from yolou_tpu_torch.kernels.attention import padded_head_dim
from yolou_tpu_torch.nn import attention

from .test_torch_port_layers import _close, _init, _load, _nchw
from .torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(a2c2f_module.__file__).parent.parent / "csrc"
RATIOS = (1.2, 2.0, 3.0, 3.5, 4.0, 6.0, 8.0)
WIDTHS = (1, 7, 20, 40, 80, 100, 200, 400, 1600)


def _up(k, m):
    return -(-k // m) * m


def _admitted():
    """(c_, heads) of every A2C2f width the gate admits: c_ a multiple of 8,
    as the bf16 kernel takes it, up to 256 = 1600 * 64 / 400, in max(1, c_
    // 32) heads, as the module builds them."""
    for c_ in range(8, 257, 8):
        heads = max(1, c_ // 32)
        if a2c2f_mega_eligible(20, 20, 512, c_, 1, heads):
            yield c_, heads


@pytest.mark.parametrize("mlp_ratio", RATIOS)
def test_every_admitted_mlp_width_has_a_plan(mlp_ratio):
    """bf16: a plan within a block at every admitted c_ (in the module's
    heads, padded to a kernel width, and in heads of 32 and of 64) and every
    image width; h stays a tile
    wherever a layout with it fits (so every plan at mlp_ratio 2 and 1.2,
    yolov12's, is as before) and moves to global memory only where none
    does. f32: one layout at every width."""
    moved = 0
    for (c_, heads), width in itertools.product(_admitted(), WIDTHS):
        module_hd = padded_head_dim(c_ // heads)
        for ca, hd in {(heads * module_hd, module_hd), (_up(c_, 32), 32),
                       (_up(c_, 64), 64)}:
            hid = _up(int(c_ * mlp_ratio), 16)
            plan = bf16_plan(c_, ca, hid, hd, width)
            where = (c_, ca, hd, width)
            assert plan is not None and plan.bytes <= _SMEM_LIMIT, where
            assert plan.ring >= 2
            tile_fits = any(bf16_layout(c_, ca, hid, hd, r, width, s)
                            <= _SMEM_LIMIT for r in (2, 3, 4) for s in (0, 1))
            assert plan.h_tile == tile_fits, where
            assert plan.bytes == bf16_layout(c_, ca, hid, hd, plan.ring,
                                             width, plan.staged, plan.h_tile)
            assert f32_smem_bytes(64, hd) <= _SMEM_LIMIT
            moved += not plan.h_tile
    assert (moved > 0) == (mlp_ratio >= 3)


def test_h_leaves_shared_memory_where_it_did_not_fit():
    """At A2C2f's head rule (max(1, c_ // 32) heads, padded to a kernel
    width) and images 20, 40 and 80 wide, the widths whose h tile passes a
    block: the ones the bf16 kernel refused before it kept h in global
    memory."""
    admitted = {c_ for c_, _ in _admitted()}
    want = {3.0: {216, 256}, 3.5: {216, 224, 256}, 4.0: {216, 224, 256},
            6.0: {c_ for c_ in admitted if c_ >= 136},
            8.0: {c_ for c_ in admitted if c_ >= 120}}
    for mlp_ratio in RATIOS:
        got = set()
        for c_, width in itertools.product(range(8, 257, 8), (20, 40, 80)):
            heads = max(1, c_ // 32)
            if not a2c2f_mega_eligible(20, 20, 512, c_, 1, heads):
                continue
            hd = padded_head_dim(c_ // heads)
            plan = bf16_plan(c_, heads * hd, _up(int(c_ * mlp_ratio), 16),
                             hd, width)
            if not plan.h_tile:
                got.add(c_)
        assert got == want.get(mlp_ratio, set()), mlp_ratio


def test_the_layout_without_the_h_tile_is_the_kernels():
    """`bf16_layout(h_tile=False)` is the CUDA `layout` at hid 0 (h in the
    `work` scratch): the GEMMs' region the x / ys / h boxes and the staging
    alone. The plan tries h as a tile first, then in global memory, each
    over the staged stencil rows and rings of 4-2 stages, as the source's
    loops do; the kernel lays out its memory with hid 0 where the wrapper
    gave it the scratch."""
    text = (CSRC / "a2c2f_bf16.cu").read_text()
    assert "for (int h_tile = 1; h_tile >= 0; --h_tile)" in text
    assert "layout(p.c_, p.ca, h_tile * p.hid, hd, ring," in text
    assert "layout(c_, ca, p.work ? 0 : p.hid, HD_, ring," in text
    assert "const int h = up64(hid) * ROWS * 2, boxes = ring * A_BLOCK * 2;" \
        in text
    assert "if (!pl.h_global) p.work = nullptr;" in text
    for args in ((256, 256, 1024, 32, 2, 20), (128, 128, 1024, 64, 4, 100),
                 (64, 64, 512, 32, 3, 40)):
        for staged in (True, False):
            assert bf16_layout(*args, staged, h_tile=False) == bf16_layout(
                *args[:2], 0, *args[3:], staged)
    # A2C2f(512, 512, mlp_ratio=4.0) at 20^2: a ring of 2 (32 KB), t and u
    # 32 KB each, the attention's region (q 16 KB, k/v 64 KB, one box of
    # 192 v rows 24 KB, pe 18 KB), 29 mbarriers, the slack
    assert bf16_plan(256, 256, 1024, 32, 20) == (
        32768 + 32768 + 32768 + 16384 + 65536 + 192 * 128 + 64 * 72 * 4
        + 8 * 29 + 1024, 2, True, False)
    assert re.search(r"constexpr int N_BARS = .*;", text)


@pytest.fixture(scope="module")
def module_pair():
    """(1, 20, 20, 128) at mlp_ratio 4.0 (h = 256, c_ = 64): JAX variables
    and the port's mega module over them."""
    x = np.random.default_rng(6).normal(0, 0.5, (1, 20, 20, 128))
    x = x.astype(np.float32)
    v = _init(jattn.A2C2f(c2=128, n=1, a2=True, area=1, mlp_ratio=4.0),
              jnp.asarray(x), seed=6)
    mega = _load(attention.A2C2f(128, 128, n=1, a2=True, area=1,
                                 mlp_ratio=4.0, mega_kernel=True), v)
    return x, v, mega


def test_module_at_mlp_ratio_4_matches_jax(module_pair, monkeypatch):
    """The port's mega route (one call of the whole-block entry with mlp1's
    (64, 256) weight) within 2e-5 of the JAX module's mega route in f32 (the
    Pallas kernel in interpret mode) and of the port's staged route."""
    x, v, mega = module_pair
    assert a2c2f_mega_eligible(20, 20, 128, 64, 1, 2)
    jmega = jattn.A2C2f(c2=128, n=1, a2=True, area=1, mlp_ratio=4.0,
                        use_pallas=True, mega_kernel=True)
    ref = jmega.apply(v, jnp.asarray(x), train=False)
    calls = []
    real = attention.a2c2f_fused
    monkeypatch.setattr(attention, "a2c2f_fused",
                        lambda *a: calls.append(a[1][8].shape) or real(*a))
    with torch.no_grad():
        got = mega(_nchw(x))
        mega.mega_kernel = False
        staged = mega(_nchw(x))
        mega.mega_kernel = True
    assert calls == [(64, 256)]
    _close(got.permute(0, 2, 3, 1), ref, atol=2e-5)
    _close(got, staged.numpy(), atol=2e-5)
    assert np.abs(np.asarray(ref)).max() > 0.05
    assert kernels.launch_counts()["a2c2f"] == 0     # the CPU: plain
