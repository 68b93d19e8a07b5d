"""PyTorch port: what the CPU can check of the bf16 whole-A2C2f kernel on
wgmma (`csrc/a2c2f_bf16.cu`), whose arithmetic runs only on the card.

* The weight packing (`pack_bf16_weight`): each GEMM weight as the kernel's
  bulk copies take it, per output panel of 128 columns and per 64-row
  block of K a [128][64] slab of w^T in
  the 128-byte swizzle; it unpacks to the weight exactly, pads with zeros
  only, and each stage starts where the kernel's producer reads it.
* The widths the wrapper pads to multiples of 8 (`pad_f32_widths(mult=8)`):
  the block's plain version is unchanged by them, and `_kernel_weights`
  gives the kernel the padded, packed list.
* The shared-memory plan (`bf16_plan`): at head widths 32 and 64 and every
  shape `a2c2f_mega_eligible` admits over yolov12 n-x at 160^2-1280^2 (and
  the gate's longest bands), at every image width of their token counts
  (the gate reads only H * W), within 232,448 bytes; square images stage
  the stencil's v rows, the widest read them through L2.
* The Python mirror's constants against the CUDA source.
* Every `tools/a2c2f_variants.py` variant written to a temporary directory:
  each replacement is found exactly once in the current source.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from yolou_tpu_torch.kernels import a2c2f as a2c2f_module
from yolou_tpu_torch.kernels.a2c2f import (_SMEM_LIMIT, _kernel_weights,
                                           a2c2f_fused_plain,
                                           a2c2f_mega_eligible, bf16_layout,
                                           bf16_panels, bf16_plan,
                                           bf16_stencil_boxes,
                                           pack_bf16_weight, pad_f32_widths,
                                           unpack_bf16_weight)
from yolou_tpu_torch.models.specs import (YOLOV12_SCALES, scale_channels,
                                          scale_depth)
from yolou_tpu_torch.tools import a2c2f_variants

from .torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(a2c2f_module.__file__).parent.parent / "csrc"


@pytest.mark.parametrize("k,n", [(64, 64), (128, 384), (80, 130), (3, 45),
                                 (256, 192), (1280, 512), (24, 200),
                                 (320, 160)])
def test_bf16_packing_round_trips_with_zero_padding(k, n):
    """Unpacked, the packed weight is the weight bit for bit; the panels'
    columns past N and the rows past K are zero; the pack is the panels'
    widths x ceil64(K) long, and stage (p, kb) of the kernel's stream,
    read at (p * ceil(K / 64) + kb) * 128 * 64, is that block's slab with
    row i's 16-byte chunk c at c ^ (i % 8)."""
    w = torch.from_numpy(np.random.default_rng(k + n).normal(
        size=(k, n)).astype(np.float32)).to(torch.bfloat16)
    packed = pack_bf16_weight(w)
    back, pad = unpack_bf16_weight(packed, k, n)
    assert torch.equal(back, w) and not pad.any()
    widths = bf16_panels(n)
    kp = -(-k // 64) * 64
    assert packed.shape == (sum(widths) * kp,)
    assert widths == [128] * -(-n // 128)
    n0 = 0
    for p, width in enumerate(widths):
        for kb in range(kp // 64):
            at = (p * (kp // 64) + kb) * 128 * 64
            slab = packed[at:at + width * 64].reshape(width, 8, 8)
            i = np.random.default_rng(p + kb).integers(width)
            for c in range(8):
                logical = slab[i, c ^ (i % 8)]
                col, rows = n0 + i, slice(64 * kb + 8 * c, 64 * kb + 8 * c + 8)
                want = (w[rows, col] if col < n else torch.zeros(0))
                got = logical[:want.shape[0]]
                assert torch.equal(got, want.to(got.dtype))
        n0 += width


@pytest.mark.parametrize("cin,c_,hid,c2", [(3, 18, 48, 45), (24, 64, 128, 36),
                                           (40, 80, 160, 96)])
def test_bf16_widths_are_padded_to_eights_exactly(cin, c_, hid, c2):
    """cin, c_ and c2 padded to multiples of 8 (the MLP is 16 already, as
    the fold pads it) leave the block's plain version unchanged in f32;
    `_kernel_weights` gives the bf16 kernel those widths, heads padded to
    32, and every GEMM weight packed."""
    rng = np.random.default_rng(cin + c_)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 8, 8, cin)).astype(np.float32))

    def mk(*s):
        return torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))

    ws = [mk(cin, c_), mk(c_)]
    for _ in range(2):
        ws += [mk(c_, 3 * c_), mk(3 * c_), mk(7, 7, c_), mk(c_), mk(c_, c_),
               mk(c_), mk(c_, hid), mk(hid), mk(hid, c_), mk(c_)]
    ws += [mk(2 * c_, c2), mk(c2)]
    heads = 1 if c_ <= 64 else 2
    xp, wp = pad_f32_widths(x, ws, 1, mult=8)
    assert xp.shape[-1] % 8 == 0 and wp[0].shape[1] % 8 == 0
    assert wp[-2].shape[1] % 8 == 0
    want = a2c2f_fused_plain(x, ws, 1, 4, heads)
    got = a2c2f_fused_plain(xp, wp, 1, 4, heads)[..., :c2]
    assert (got - want).abs().max().item() <= 1e-6
    bx = x.to(torch.bfloat16)
    bw = [w.to(torch.bfloat16) if w.dim() == 2 else w for w in ws]
    xk, wk, dims = _kernel_weights(bx, bw, 1, heads)
    up = lambda v, m: -(-v // m) * m
    hdp = 32 if c_ // heads <= 32 else 64
    assert dims == (up(cin, 8), up(c_, 8), heads * hdp, hid, up(c2, 8), hdp)
    assert torch.equal(xk[..., :cin], bx) and not xk[..., cin:].any()
    assert wk[0].dim() == 1 and wk[-2].dim() == 1
    back, pad = unpack_bf16_weight(wk[-2], 2 * dims[1], dims[4])
    assert torch.equal(back[:c_, :c2], bw[-2][:c_]) and not pad.any()


def _gated(mlp_ratio):
    """(hw, cin, c_, area, hid, n_stages) of yolov12 n-x's layers 6 and 8 at
    160^2-1280^2 (steps of 32) that the gate admits, then the gate's
    longest bands (c_ 32 and 64 at area 1, modules no graph builds)."""
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
    for hw, c_ in itertools.product(range(20, 57, 4), (32, 64)):
        if a2c2f_mega_eligible(hw, hw, 32, c_, 1, c_ // 32):
            yield hw, 32, c_, 1, int(c_ * mlp_ratio), 1


@pytest.mark.parametrize("mlp_ratio", [2.0, 1.2])
@pytest.mark.parametrize("hd", [32, 64])
def test_bf16_plan_fits_every_gated_shape(mlp_ratio, hd):
    """At heads of `hd` channels (the kernel's widths; others are padded to
    them), every gated shape, square or a strip of any width (the gate
    admits every H x W of an admitted token count), fits a block with a
    weight ring of at least 2 stages (the plan reads neither cin nor the
    stage count); square images and taller ones stage the stencil's v
    rows, the plan drops them only where they do not fit, and
    yolov12n's layers 6 and 8 at 640^2 take the full ring of 4, as do
    their strips (16, 100) and (8, 100), with the rows read through L2."""
    shapes = list(_gated(mlp_ratio))
    assert len(shapes) == 10 + 16
    for hw, cin, c_, area, hid, depth in shapes:
        hidp = -(-hid // 16) * 16
        ca = -(-c_ // hd) * hd
        n = hw * hw
        for width in (w for w in range(1, n + 1) if n % w == 0):
            assert a2c2f_mega_eligible(n // width, width, cin, c_, area,
                                       max(1, c_ // 32))
            plan = bf16_plan(c_, ca, hidp, hd, width)
            assert plan is not None, (hw, width, c_, hd)
            assert plan[0] <= _SMEM_LIMIT == 232_448
            if width <= hw:
                assert plan[2], (hw, width, c_, hd)
            if not plan[2]:      # no ring fits the rows
                assert all(bf16_layout(c_, ca, hidp, hd, r, width)
                           > _SMEM_LIMIT for r in (2, 3, 4))
    if hd == 32:
        assert bf16_plan(64, 64, 128, 32, 40)[1:] == (4, True, True)  # L6
        assert bf16_plan(128, 128, 256, 32, 20)[1:] == (4, True, True)
        assert bf16_plan(64, 64, 128, 32, 100)[1:] == (4, False, True)
        assert bf16_plan(128, 128, 256, 32, 100)[1:] == (4, False, True)


def test_bf16_stencil_boxes_cover_the_tile_and_its_halo():
    """The v rows of a 64-token tile +- 3 image rows and 3 tokens, in the
    fewest boxes of at most 256 rows, each a multiple of 8."""
    for width in (1, 7, 20, 28, 40, 56, 80, 160):
        rows, boxes = bf16_stencil_boxes(width)
        assert rows % 8 == 0 and rows <= 256
        assert rows * boxes >= 64 + 6 * width + 6
        assert rows * (boxes - 1) < 64 + 6 * width + 6


def test_the_bf16_layout_constants_are_the_kernels():
    """`bf16_layout` and `bf16_plan` mirror a2c2f_bf16.cu: its tile rows,
    block columns, panel, ring stages, keys a tile, positional term's row,
    box rows, stencil block, staged accumulator's row, mbarriers and
    shared-memory limit; the k/v rings by head width; and the layout at
    yolov12n's layer 6."""
    text = (CSRC / "a2c2f_bf16.cu").read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    got = tuple(constant(n) for n in ("ROWS", "KBLK", "PANEL", "MAX_RING",
                                      "KV_KEYS", "PE_LD", "VB_MAX", "CBLK",
                                      "STAGE_LD"))
    assert got == (a2c2f_module._ROWS, a2c2f_module._KBLK,
                   a2c2f_module._PANEL, a2c2f_module._MAX_RING,
                   a2c2f_module._KV_KEYS, a2c2f_module._PE_LD,
                   a2c2f_module._VB_MAX, a2c2f_module._CBLK,
                   a2c2f_module._STAGE_LD)
    assert "constexpr int N_BARS = 2 * MAX_RING + 4 * KV_STAGES + 4 * 2 + 5;" \
        in text
    assert constant("KV_STAGES") == a2c2f_module._KV_STAGES == 2
    assert 2 * 4 + 4 * 2 + 4 * 2 + 5 == a2c2f_module._N_BARS
    assert "constexpr int SMEM_LIMIT = 227 * 1024 - 1024;" in text
    assert a2c2f_module._BF16_SMEM_LIMIT == 227 * 1024 - 1024
    assert "return hd == 64 ? 1 : 2;" in text
    assert "for (int staged = 1; staged >= 0; --staged)" in text
    # ring 64 KB, t and u 8 KB each, the attention's region (q 16 KB, k/v
    # 64 KB, 2 boxes of 160 v rows 40 KB, pe 18 KB), the mbarriers, the slack
    assert bf16_layout(64, 64, 128, 32, 4, 40) == (
        65536 + 8192 + 8192 + 16384 + 65536 + 320 * 128 + 64 * 72 * 4
        + 8 * 29 + 1024)
    assert bf16_layout(64, 64, 128, 32, 4, 40, staged=False) == (
        bf16_layout(64, 64, 128, 32, 4, 40) - 320 * 128)


@pytest.mark.parametrize("name", sorted(a2c2f_variants.VARIANTS))
def test_every_phase_variant_applies_to_the_source(name, tmp_path):
    """Each variant's replacements occur exactly once in its source (the
    tool raises otherwise) and change it; the other sources are copied as
    they are."""
    dst = a2c2f_variants.write_variant(name, tmp_path)
    source = a2c2f_variants.VARIANTS[name][0]
    assert (dst / source).read_text() != (CSRC / source).read_text()
    for f in CSRC.iterdir():
        if f.is_file() and f.name != source:
            assert (dst / f.name).read_bytes() == f.read_bytes()
