"""PyTorch port: kernel C at head widths no kernel is built for, padded
inside the kernel, and the f32 blocked form's thread-block clusters.

On the card kernel C views q, k and v as (G, N, heads, hd) tensor maps whose
boxes are as wide as the kernel's head (32, 64 or a 64-channel block): TMA
fills the channels past hd with zeros and the stores stop at them, so a
call is one device kernel and no copy, wherever a head's row is a multiple
of 16 bytes (`in_kernel_pad`). Other widths keep the wrappers' copies
(`pad_heads`, `cut_heads`). On the CPU the plain versions run at the true
width. The f32 blocked form runs a cluster of CTAs a (head, query tile),
one a 64-channel block, and sums their partial scores in rank order
(`cluster_shape`). What the CPU can check:

  * `in_kernel_pad` against a table of widths and types, and against the
    rule of hopper.cuh's `pads_in_kernel`;
  * `area_attention_fused` and `area_attention` at heads of 16, 48, 96 and
    12 against the JAX package's Pallas kernels in interpret mode within
    1e-5, as `test_torch_port_head_widths.py` does;
  * a torch emulation of the cluster form's arithmetic (each CTA's partial
    scores over its blocks, summed in rank order; the online softmax over
    key tiles of 64) against the Pallas `area_attention_fused` at heads of
    96, 128 and of 1088 (two groups of clusters), within 1e-5;
  * the cluster form's host-side constants (cluster size and groups by
    head width, shared memory) against band_attention.cu's.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import area_attention as jax_single
from yolou_tpu.ops.pallas_attn import area_attention_fused as jax_fused
from yolou_tpu_torch.kernels import attention as attn
from yolou_tpu_torch.kernels.attention import (
    _SMEM_LIMIT, BLOCK, area_attention, area_attention_fused,
    blocked_smem_bytes, cluster_shape, cut_heads, in_kernel_pad, pad_heads,
    padded_head_dim)

from .torch_threads import one_torch_thread  # noqa: F401

CSRC = Path(attn.__file__).parent.parent / "csrc"
F32, BF16 = torch.float32, torch.bfloat16
ATOL = 1e-5
LOG2E = 1.4426950408889634


def test_which_widths_the_kernel_pads():
    """Widths no kernel is built for (not 32, 64 or a multiple of 64) whose
    row is a multiple of 16 bytes: bf16 hd % 8 == 0, f32 hd % 4 == 0."""
    table = {8: (True, True), 12: (False, True), 16: (True, True),
             20: (False, True), 24: (True, True), 32: (False, False),
             40: (True, True), 48: (True, True), 56: (True, True),
             60: (False, True), 63: (False, False), 64: (False, False),
             72: (True, True), 96: (True, True), 100: (False, True),
             120: (True, True), 128: (False, False), 192: (False, False),
             928: (True, True), 1: (False, False), 2: (False, False),
             4: (False, True)}
    for hd, (bf16, f32) in table.items():
        assert in_kernel_pad(hd, BF16) == bf16, hd
        assert in_kernel_pad(hd, F32) == f32, hd
    text = (CSRC / "hopper.cuh").read_text()
    assert ("return hd > 0 && hd != 32 && hd != 64 && hd % 64 != 0 &&\n"
            "         hd * (f32 ? 4 : 2) % 16 == 0;") in text
    assert ("return hd <= 32 ? 32 : hd <= 64 ? 64 : (hd + 63) / 64 * 64;"
            in text)
    for hd in range(1, 300):
        assert padded_head_dim(hd) == (32 if hd <= 32 else 64 if hd <= 64
                                       else -(-hd // 64) * 64)


@pytest.mark.parametrize("hd", [16, 48, 96, 12])
def test_kernel_c_at_padded_widths_matches_pallas(hd):
    """Two heads and the one-head entry at bands of 20 tokens, the port's
    entries on the CPU (the plain version at the true width) against the
    Pallas kernels in interpret mode."""
    heads = 2
    rng = np.random.default_rng(hd + 5)
    q, k, v = (rng.normal(size=(3, 20, heads * hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), heads,
                                interpret=True))
    got = area_attention_fused(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    want1 = np.asarray(jax_single(*map(jnp.asarray, (q, k, v)),
                                  interpret=True))
    got1 = area_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got1.numpy(), want1, rtol=0, atol=ATOL)


def cluster_attention(q, k, v, heads):
    """The f32 cluster form on (G, N, C) f32 at heads of any width past 64,
    zero-padded to hdp: for each key tile of 64, CTA rank r of a cluster
    of cs scores its blocks r, r + cs, ... (one FMA chain a block, over its
    64 channels in order, added to the CTA's partial), the partials are
    summed in rank order, then the online softmax step (log2 units) and
    p.v on each output block; cut back to hd."""
    g, n, c = q.shape
    hd = c // heads
    hdp = padded_head_dim(hd)
    cs, _ = cluster_shape(hdp)
    nbk, sl2 = hdp // BLOCK, hd ** -0.5 * LOG2E

    def split(t):
        return pad_heads(t, heads, hdp).reshape(g, n, heads, hdp).transpose(
            1, 2)

    q, k, v = (split(t) for t in (q, k, v))
    m = torch.full((g, heads, n, 1), -torch.inf)
    l = torch.zeros(g, heads, n, 1)
    acc = torch.zeros(g, heads, n, hdp)
    for k0 in range(0, n, 64):
        kt, vt = k[..., k0:k0 + 64, :], v[..., k0:k0 + 64, :]
        s = None
        for rank in range(cs):
            part = torch.zeros(g, heads, n, kt.shape[-2])
            for blk in range(rank, nbk, cs):
                j = BLOCK * blk
                part = part + (q[..., j:j + BLOCK]
                               @ kt[..., j:j + BLOCK].transpose(-1, -2))
            s = part if s is None else s + part
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s * sl2 - m_new * sl2)
        c_ = torch.exp2((m - m_new) * sl2)
        l = l * c_ + p.sum(-1, keepdim=True)
        acc = acc * c_ + p @ vt
        m = m_new
    o = (acc / l).transpose(1, 2).reshape(g, n, heads * hdp)
    return cut_heads(o, heads, hd)


@pytest.mark.parametrize("hd,heads,n", [(96, 2, 25), (128, 2, 100),
                                        (1088, 1, 70)])
def test_cluster_form_matches_pallas(hd, heads, n):
    """The cluster form's emulation at heads of 96 (padded to 128: a
    cluster of 2), 128 over ragged key tiles, and 1088 (17 blocks: two
    clusters of 9, each CTA scoring two blocks but the last), against the
    Pallas `area_attention_fused` in interpret mode within 1e-5."""
    cs, groups = cluster_shape(padded_head_dim(hd))
    assert (cs, groups) == ((2, 1) if hd <= 128 else (9, 2))
    rng = np.random.default_rng(hd + n)
    q, k, v = (rng.normal(size=(2, n, heads * hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_fused(*map(jnp.asarray, (q, k, v)), heads,
                                interpret=True))
    got = cluster_attention(*map(torch.from_numpy, (q, k, v)), heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert np.abs(want).max() > 0.05


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])


def test_the_cluster_constants_are_the_kernels():
    """`cluster_shape` and `blocked_smem_bytes` are band_attention.cu's
    `cluster_size` / `cluster_groups` and `blocked_smem` over its
    constants: one cluster of hdp / 64 CTAs up to 16 (hdp <= 1024, the
    non-portable size past 8), as few even groups past it; shared memory
    one number up to 1024 channels, two CTAs an SM, 8 KB more a group, and
    within a block up to the widest head the form takes (17408)."""
    text = (CSRC / "band_attention.cu").read_text()
    cmax, kst, vst, rows, kf, ldp, blk = (_constant(text, n) for n in (
        "CLUSTER_MAX", "K_STAGES", "CV_STAGES", "BLOCKED_F32_ROWS", "KB_F32",
        "LDP", "BLK"))
    assert (cmax, kst, vst, rows, blk) == (
        attn._CLUSTER_MAX, attn._K_STAGES, attn._CV_STAGES, 32, BLOCK)
    assert ("return (nbk + CLUSTER_MAX - 1) / CLUSTER_MAX;" in text
            and "return (nbk + cluster_groups(nbk) - 1) / cluster_groups(nbk);"
            in text)
    for nbk in range(2, 300):
        groups = -(-nbk // cmax)
        cs = -(-nbk // groups)
        assert cluster_shape(BLOCK * nbk) == (cs, groups)
        assert cs <= cmax and cs * groups >= nbk
        smem = (1024 + 4 * (groups * rows * blk + (kst + vst) * kf * blk
                            + 2 * rows * kf + rows * ldp)
                + 8 * (2 * (kst + vst) + 1))
        assert blocked_smem_bytes(BLOCK * nbk, F32) == smem
        assert (smem <= _SMEM_LIMIT) == (nbk <= 272)
    assert {blocked_smem_bytes(hdp, F32) for hdp in range(128, 1025, 64)} \
        == {attn._BLOCKED_SMEM[F32]}
    assert cluster_shape(960) == (15, 1) and cluster_shape(512) == (8, 1)
    plan = attn.attention_plan(2, 400, 2 * 1088, F32, False, hd=1088)
    assert plan.smem == blocked_smem_bytes(1088, F32) > attn._BLOCKED_SMEM[F32]
    assert "attr[0].val.clusterDim.x = cs;" in text
    assert "cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)" in text
