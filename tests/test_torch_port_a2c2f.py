"""PyTorch port: the whole-A2C2f block kernel's plain version and its routing
against the JAX package, on the CPU.

On the CPU `a2c2f_fused` runs `a2c2f_fused_plain`, which carries the CUDA
kernel's rounding points; it is held against the Pallas kernel in interpret
mode and against the JAX package's plain composition. The module route
(`A2C2f(mega_kernel=True)`) is held against the JAX module's and against the
port's own staged route, and the gate against the JAX gate.
"""

import copy
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.nn import attention as jattn
from yolou_tpu.ops.pallas_a2c2f import a2c2f_fused as jax_fused
from yolou_tpu.ops.pallas_a2c2f import a2c2f_mega_eligible as jax_gate
from yolou_tpu.ops.pallas_a2c2f import a2c2f_reference
from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels.a2c2f import (a2c2f_fused, a2c2f_fused_plain,
                                           a2c2f_mega_eligible)
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.nn import attention

from .test_torch_port_layers import _close, _init, _load, _nchw

# the two shapes of tests/test_pallas_a2c2f.py
CASES = [((2, 16, 16, 32), dict(c_=32, c2=64, n_stages=2, area=4, heads=1)),
         ((1, 8, 8, 24), dict(c_=64, c2=48, n_stages=1, area=1, heads=2))]


def _weights(rng, cin, c_, c2, n_stages):
    mk = lambda *s: rng.normal(0, 0.05, s).astype(np.float32)
    ws = [mk(cin, c_), mk(c_)]
    for _ in range(2 * n_stages):
        ws += [mk(c_, 3 * c_), mk(3 * c_), mk(7, 7, c_), mk(c_),
               mk(c_, c_), mk(c_), mk(c_, 2 * c_), mk(2 * c_),
               mk(2 * c_, c_), mk(c_)]
    return ws + [mk((n_stages + 1) * c_, c2), mk(c2)]


def _is_gemm_weight(i, n):
    return i % 2 == 0 and (i < 2 or i >= n - 2 or (i - 2) % 10 != 2)


def _cast(ws, jdt, tdt):
    """GEMM weights in the I/O type, biases and pe kernels f32, both sides."""
    n = len(ws)
    jw = [jnp.asarray(w).astype(jdt) if _is_gemm_weight(i, n)
          else jnp.asarray(w) for i, w in enumerate(ws)]
    tw = [torch.from_numpy(w).to(tdt) if _is_gemm_weight(i, n)
          else torch.from_numpy(w) for i, w in enumerate(ws)]
    return jw, tw


@pytest.mark.parametrize("shape,cfg", CASES)
def test_plain_matches_pallas_interpret_and_reference_f32(shape, cfg):
    """f32 within 2e-5 of the Pallas kernel (interpret mode) and of the JAX
    plain composition: the same products in another summation order."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    ws = _weights(rng, shape[-1], cfg["c_"], cfg["c2"], cfg["n_stages"])
    jw, tw = _cast(ws, jnp.float32, torch.float32)
    args = (cfg["n_stages"], cfg["area"], cfg["heads"])
    got = a2c2f_fused_plain(torch.from_numpy(x), tw, *args)
    assert got.shape == shape[:3] + (cfg["c2"],) and got.dtype == torch.float32
    kern = jax_fused(jnp.asarray(x), jw, *args, interpret=True)
    ref = a2c2f_reference(jnp.asarray(x), jw, *args)
    _close(got, kern, atol=2e-5)
    _close(got, ref, atol=2e-5)


@pytest.mark.parametrize("shape,cfg", CASES)
def test_plain_matches_pallas_interpret_bf16(shape, cfg):
    """bf16 I/O within 2e-2 of the Pallas kernel in interpret mode: both
    round at the same points, but XLA's CPU dots and torch's sum in another
    order, and one flipped bf16 rounding (2^-8 relative) of an activation of
    order 1 propagates through the following GEMMs."""
    rng = np.random.default_rng(1)
    x = rng.normal(0, 0.5, shape).astype(np.float32)
    ws = _weights(rng, shape[-1], cfg["c_"], cfg["c2"], cfg["n_stages"])
    jw, tw = _cast(ws, jnp.bfloat16, torch.bfloat16)
    args = (cfg["n_stages"], cfg["area"], cfg["heads"])
    got = a2c2f_fused_plain(torch.from_numpy(x).to(torch.bfloat16), tw, *args)
    assert got.dtype == torch.bfloat16
    kern = jax_fused(jnp.asarray(x).astype(jnp.bfloat16), jw, *args,
                     interpret=True)
    _close(got.float(), kern.astype(jnp.float32), atol=2e-2)


def test_wrapper_takes_the_plain_version_on_the_cpu_and_checks_inputs():
    shape, cfg = CASES[1]
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(0, 0.5, shape).astype(np.float32))
    tw = _cast(_weights(rng, 24, 64, 48, 1), jnp.float32, torch.float32)[1]
    kernels.reset_launch_counts()
    out = a2c2f_fused(x, tw, 1, 1, 2)
    assert torch.equal(out, a2c2f_fused_plain(x, tw, 1, 1, 2))
    assert kernels.launch_counts()["a2c2f"] == 0
    with pytest.raises(ValueError, match="n_stages"):
        a2c2f_fused(x, tw, 2, 1, 2)
    with pytest.raises(ValueError, match="heads"):
        a2c2f_fused(x, tw, 1, 1, 3)
    with pytest.raises(ValueError, match="bands"):
        a2c2f_fused(x, tw, 1, 5, 2)
    with pytest.raises(TypeError, match="weight is"):
        a2c2f_fused(x.to(torch.bfloat16), tw, 1, 1, 2)
    with pytest.raises(TypeError, match="float32"):
        a2c2f_fused(x, [tw[0], tw[1].double(), *tw[2:]], 1, 1, 2)
    with pytest.raises(ValueError, match="proj0"):
        a2c2f_fused(x, [*tw[:6], tw[6][:, :32].contiguous(), *tw[7:]], 1, 1, 2)
    with pytest.raises(ValueError, match=r"\(B, H, W, cin\)"):
        a2c2f_fused(x[0], tw, 1, 1, 2)


def test_gate_equals_the_jax_gate():
    grid = itertools.product((5, 10, 16, 20, 25, 40, 80), (5, 20, 40, 80),
                             (24, 128, 512, 1024), (32, 64, 128, 256),
                             (1, 3, 4), (1, 2, 3, 4))
    n = 0
    for H, W, cin, c_, area, heads in grid:
        assert (a2c2f_mega_eligible(H, W, cin, c_, area, heads)
                == jax_gate(H, W, cin, c_, area, heads)), (H, W, cin, c_,
                                                           area, heads)
        n += 1
    assert n > 1000
    assert a2c2f_mega_eligible(40, 40, 128, 64, 4, 2)      # layer 6 at 640
    assert a2c2f_mega_eligible(20, 20, 256, 128, 1, 4)     # layer 8 at 640
    assert not a2c2f_mega_eligible(5, 5, 256, 128, 1, 4)   # layer 8 at 160


@pytest.fixture(scope="module")
def module_pair():
    """JAX A2C2f variables at the smallest eligible shape and the port's
    staged and mega modules over the converted weights."""
    x = np.random.default_rng(3).normal(0, 0.5, (2, 20, 20, 64))
    x = x.astype(np.float32)
    jstaged = jattn.A2C2f(c2=64, n=1, a2=True, area=1)
    v = _init(jstaged, jnp.asarray(x), seed=3)
    staged = _load(attention.A2C2f(64, 64, n=1, a2=True, area=1), v)
    mega = _load(attention.A2C2f(64, 64, n=1, a2=True, area=1,
                                 mega_kernel=True), v)
    return x, v, staged, mega


def test_module_mega_route_matches_jax_mega_route(module_pair):
    """(2, 20, 20, 64): the JAX module's mega route (the Pallas kernel in
    interpret mode on the CPU) within 2e-5 in f32."""
    x, v, _, mega = module_pair
    jmega = jattn.A2C2f(c2=64, n=1, a2=True, area=1, use_pallas=True,
                        mega_kernel=True)
    ref = jmega.apply(v, jnp.asarray(x), train=False)
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = mega(_nchw(x))
    _close(got.permute(0, 2, 3, 1), ref, atol=2e-5)
    assert kernels.launch_counts() == {k: 0 for k in kernels.launch_counts()}


def test_module_mega_route_matches_its_staged_route(module_pair, monkeypatch):
    x, _, staged, mega = module_pair
    assert list(staged.state_dict()) == list(mega.state_dict())
    calls = []
    real = attention.a2c2f_fused
    monkeypatch.setattr(attention, "a2c2f_fused",
                        lambda *a: calls.append(a[2:]) or real(*a))
    with torch.no_grad():
        a, b = staged(_nchw(x)), mega(_nchw(x))
    assert calls == [(1, 1, 1)]              # n_stages, area, heads
    _close(a, b.numpy(), atol=2e-5)
    # an ineligible shape (100 tokens) takes the staged modules
    small = _nchw(x[:, :10, :10])
    with torch.no_grad():
        assert torch.equal(staged(small), mega(small))
    assert len(calls) == 1


def test_folded_weights_are_kept_until_the_block_changes(module_pair):
    """The folding is cached per dtype and redone when a parameter or buffer
    is written in place (an optimizer step, `load_state_dict`)."""
    x, _, staged, mega = module_pair
    m, ref = copy.deepcopy(mega), copy.deepcopy(staged)
    first = m.folded_weights(torch.float32)
    assert m.folded_weights(torch.float32) is first
    assert m.folded_weights(torch.bfloat16)[0].dtype == torch.bfloat16
    with torch.no_grad():
        m.cv1.bn.running_mean.add_(0.5)
        m.m[0][1].attn.pe.conv.weight.mul_(2.0)
    assert m.folded_weights(torch.float32) is not first
    ref.load_state_dict(m.state_dict())
    with torch.no_grad():
        _close(m(_nchw(x)), ref(_nchw(x)).numpy(), atol=2e-5)
        assert not torch.allclose(m(_nchw(x)), mega(_nchw(x)), atol=1e-3)


def test_training_mode_never_takes_the_mega_route(module_pair, monkeypatch):
    x, _, _, mega = module_pair
    monkeypatch.setattr(attention, "a2c2f_fused", lambda *a: pytest.fail(
        "training mode reached the whole-block kernel"))
    mega.train()
    try:
        y = mega(_nchw(x))
    finally:
        mega.eval()
    assert y.shape == (2, 64, 20, 20) and y.requires_grad


def test_whole_model_mega_matches_staged_at_640(monkeypatch):
    """yolov12n-seg at 640^2, batch 1, f32, seeded weights: layers 6 and 8
    go through the whole-block entry (two calls a forward, counted here on
    its way to the plain version) and the staged model through the band
    attention entry (8 calls); the raw maps within 1e-4 of each other and
    preds within 1e-3 (boxes are pixels up to 640, where one f32 ulp is
    6e-5)."""
    staged = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                        device="cpu", seed=5)
    mega = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu", mega_kernel=True)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (1, 4, 640, 640), np.float32))
    # identity BatchNorm statistics let a random network's activations
    # vanish: set every BatchNorm's statistics to this input's (one training
    # pass at momentum 1) and its scale to 0.1
    bns = [m for m in staged.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.fill_(0.1)
            bn.momentum = 1.0
        staged.train()(x)
    staged.eval()
    mega.load_state_dict(staged.state_dict(), strict=True)
    counts = {"a2c2f": 0, "band_attention": 0}
    real_mega, real_attn = (attention.a2c2f_fused,
                            attention.area_attention_qkv_fused)

    def mega_entry(x, *a):
        counts["a2c2f"] += 1
        assert x.shape[1:] in ((40, 40, 128), (20, 20, 256))
        return real_mega(x, *a)

    def attn_entry(*a):
        counts["band_attention"] += 1
        return real_attn(*a)

    monkeypatch.setattr(attention, "a2c2f_fused", mega_entry)
    monkeypatch.setattr(attention, "area_attention_qkv_fused", attn_entry)
    with torch.no_grad():
        got = mega(x)
        assert counts == {"a2c2f": 2, "band_attention": 0}
        want = staged(x)
        assert counts == {"a2c2f": 2, "band_attention": 8}
    assert float(want.preds[..., 4].std()) > 1e-4    # not a dead network
    _close(got.preds, want.preds.numpy(), atol=1e-3)
    for a, b in zip(got.raw, want.raw):
        _close(a, b.numpy(), atol=1e-4)
    assert kernels.launch_counts()["a2c2f"] == 0     # CPU: plain, not counted


def test_smoke_run_seeds_a_block_of_order_one():
    """`chip_smoke.py::seeded_a2c2f`, the block the whole-A2C2f kernel is
    checked and timed on: the same for one seed, in eval mode, folds to the
    kernel's weight list, and its outputs are of order 1, where a bf16
    tolerance means something."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    a, b, c = (smoke.seeded_a2c2f(64, 64, 1, 1, "cpu", s) for s in (0, 0, 1))
    assert all(torch.equal(v, b.state_dict()[k])
               for k, v in a.state_dict().items())
    assert not torch.equal(a.cv1.conv.weight, c.cv1.conv.weight)
    assert not a.training and len(a.folded_weights(torch.float32)) == 24
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(1, 64, 20, 20)).astype(np.float32))
    with torch.no_grad():
        assert 0.05 < float(a(x).abs().max()) < 5.0      # of order 1
