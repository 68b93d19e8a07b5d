"""PyTorch port: the slice's layers against the JAX modules, f32 on the CPU.

Random weights for the JAX modules (BN statistics included) are carried
across by `state_dict_from_jax`; inputs are numpy draws fed to both.
Tolerance 1e-5 absolute: both sides compute in f32, sums in another order.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.nn import attention as jattn
from yolou_tpu.nn import blocks as jblocks
from yolou_tpu.nn import heads as jheads
from yolou_tpu_torch.nn import attention, blocks, heads
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5


def _init(jmod, inputs, seed=0):
    """Random JAX variables drawn with numpy (shapes from eval_shape, which
    is faster than flax's init): kernels N(0, 1/fan_in), biases N(0, .1), BN
    scale 1 + N(0, .1), running mean N(0, .1), running variance in [.5, 1)."""
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.key(0), inputs,
                                              train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name == "var":
            a = rng.random(s.shape) * 0.5 + 0.5
        elif name == "scale":
            a = 1.0 + rng.normal(0, 0.1, s.shape)
        else:                                   # bias, mean
            a = rng.normal(0, 0.1, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _nchw(a):
    return torch.from_numpy(np.asarray(a).transpose(0, 3, 1, 2).copy())


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def _load(tmod, variables, allow_missing=()):
    missing, unexpected = tmod.load_state_dict(state_dict_from_jax(variables),
                                               strict=False)
    assert not unexpected and sorted(missing) == sorted(allow_missing)
    return tmod.eval()


@pytest.mark.parametrize("c3k", [False, True])
def test_c3k2_matches_jax(c3k):
    x = np.random.default_rng(1).normal(size=(2, 8, 8, 32)).astype(np.float32)
    jmod = jblocks.C3k2(64, n=2, c3k=c3k, e=0.5)
    v = _init(jmod, jnp.asarray(x))
    ref = jmod.apply(v, jnp.asarray(x), train=False)
    tmod = _load(blocks.C3k2(32, 64, n=2, c3k=c3k, e=0.5), v)
    with torch.no_grad():
        _close(tmod(_nchw(x)).permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("a2,area,c2", [(True, 4, 128), (True, 1, 64),
                                        (False, 1, 64)])
def test_a2c2f_matches_jax(a2, area, c2):
    """Backbone A2C2f (area bands, 2 heads at c2=128 -> kernel A's plain
    version on the CPU) and neck A2C2f (C3k stages)."""
    x = np.random.default_rng(2).normal(0, 0.25, (2, 8, 8, 64))
    x = x.astype(np.float32)
    jmod = jattn.A2C2f(c2, n=1, a2=a2, area=area)
    v = _init(jmod, jnp.asarray(x))
    ref = jmod.apply(v, jnp.asarray(x), train=False)
    tmod = _load(attention.A2C2f(64, c2, n=1, a2=a2, area=area), v)
    with torch.no_grad():
        _close(tmod(_nchw(x)).permute(0, 2, 3, 1), ref)


def test_aattn_training_mode_is_refused():
    """The name dates from when the training attention kernel was missing
    and training mode raised; it is kept so that the test's history stays in
    one line. Training mode now runs, through the differentiable entry
    point, and at momentum 1 eval mode reproduces its output."""
    m = attention.AAttn(64, 2, 1).train()
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    y = m(x)
    assert y.shape == x.shape
    y.square().sum().backward()
    assert x.grad is not None and bool(x.grad.abs().sum() > 0)
    assert all(p.grad is not None for p in m.parameters())
    for conv in (m.qkv, m.pe, m.proj):      # momentum 1: eval == this batch
        conv.bn.momentum = 1.0
        conv.bn.reset_running_stats()
    with torch.no_grad():
        y = m(x)
        # the eval path folds running stats with the biased-variance update,
        # so with momentum 1 it reproduces the batch-statistics forward
        torch.testing.assert_close(m.eval()(x), y, atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def segment_pair():
    rng = np.random.default_rng(3)
    ch = (64, 128, 256)
    feats = [rng.normal(size=(2, hw, hw, c)).astype(np.float32)
             for c, hw in zip(ch, (8, 4, 2))]
    jmod = jheads.Segment(nc=1, nm=32, npr=64, reg_max=16)
    v = _init(jmod, [jnp.asarray(f) for f in feats])
    raw, mc, protos = jmod.apply(v, [jnp.asarray(f) for f in feats],
                                 train=False)
    tmod = _load(heads.Segment(1, 32, 64, ch, 16), v,
                 allow_missing=["dfl.conv.weight"])
    with torch.no_grad():
        out = tmod([_nchw(f) for f in feats])
    return (raw, mc, protos), out, v, tmod


def test_segment_matches_jax(segment_pair):
    (raw, mc, protos), (raw_t, mc_t, protos_t), _, _ = segment_pair
    for rj, rt in zip(raw, raw_t):
        _close(rt.permute(0, 2, 3, 1), rj)
    _close(mc_t, mc)
    _close(protos_t.permute(0, 2, 3, 1), protos)


def test_decode_detections_matches_jax(segment_pair):
    (raw, _, _), (raw_t, _, _), _, _ = segment_pair
    ref = jheads.decode_detections(raw, (8, 16, 32), 1, 16)
    got = heads.decode_detections(raw_t, (8, 16, 32), 1, 16)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    # boxes in grid units (pixels / stride): a stride of 32 would scale the
    # f32 rounding of the DFL expectation (~1e-6 of 15 bins) past 1e-5 px
    stride = np.concatenate([np.full(hw * hw, s, np.float32)
                             for hw, s in ((8, 8), (4, 16), (2, 32))])
    ref = np.asarray(ref).copy()
    ref[..., :4] /= stride[None, :, None]
    got = got.clone()
    got[..., :4] /= torch.from_numpy(stride)[None, :, None]
    _close(got, ref)


def test_warm_start_bias_matches_jax(segment_pair):
    _, _, v, tmod = segment_pair
    vj = {"params": jheads.warm_start_detect_bias(v["params"]),
          "batch_stats": v["batch_stats"]}
    tmod = heads.warm_start_detect_bias(copy.deepcopy(tmod))
    want = state_dict_from_jax(jax.device_get(vj))
    got = tmod.state_dict()
    for k, t in want.items():
        assert torch.equal(got[k], t), k
