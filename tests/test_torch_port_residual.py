"""PyTorch port: the residual-gamma A2C2f against the JAX module.

`A2C2f(..., residual=True)` (attention stages, c1 == c2) returns
x + gamma * block(x) with a learnable per-channel `gamma` (c2,), initialised
to 0.01, as `yolou_tpu/nn/attention.py::A2C2f` does. Held here in f32 on the
CPU: the eval and train forwards, the gradients of gamma and of the input
against `jax.grad`, the weights across both packages bit for bit, the mega
route never taken, gamma in the optimizer's "decay" group and replicated
under a model axis.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.nn import attention as jattn
from yolou_tpu_torch.engine.trainer_detector import parameter_groups
from yolou_tpu_torch.nn import attention
from yolou_tpu_torch.parallel import mesh as meshlib
from yolou_tpu_torch.tools.convert import jax_variables, state_dict_from_jax

from .test_torch_port_layers import _close, _init, _load, _nchw
from .torch_threads import one_torch_thread  # noqa: F401

SHAPE = (2, 8, 8, 64)          # B, H, W, c1 = c2
ARGS = dict(n=2, a2=True, area=4, residual=True, mlp_ratio=1.2)


@pytest.fixture(scope="module")
def pair():
    """Seeded JAX variables (gamma drawn like a bias, N(0, 0.1), so that it
    is not the 0.01 of both inits) and the port's module over them."""
    x = np.random.default_rng(7).normal(0, 0.5, SHAPE).astype(np.float32)
    jmod = jattn.A2C2f(c2=64, **ARGS)
    v = _init(jmod, jnp.asarray(x), seed=7)
    assert v["params"]["gamma"].shape == (64,)
    tmod = _load(attention.A2C2f(64, 64, **ARGS), v)
    return x, jmod, v, tmod


def test_init_gives_gamma_of_0_01():
    m = attention.A2C2f(64, 64, **ARGS)
    assert torch.equal(m.gamma.detach(), torch.full((64,), 0.01))
    assert "gamma" not in dict(attention.A2C2f(64, 64, n=2).named_parameters())
    assert not attention.A2C2f(64, 64, n=1, a2=False, residual=True).residual


def _rel(ref):
    """1e-5 of the largest magnitude: f32 sums in another order through two
    attention stages of a random block whose outputs reach ~20."""
    return 1e-5 * float(np.abs(np.asarray(ref)).max())


def test_eval_forward_matches_jax(pair):
    x, jmod, v, tmod = pair
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = tmod.eval()(_nchw(x))
    _close(got.permute(0, 2, 3, 1), ref, atol=_rel(ref))


def _train_apply(jmod):
    def f(v, x):
        out, _ = jmod.apply(v, x, train=True, mutable=["batch_stats"])
        return out
    return f


def test_train_forward_matches_jax(pair):
    """Batch statistics and kernel C's plain version, within 1e-5 of the
    largest magnitude. Runs on a copy: the pair's BatchNorm statistics stay
    the JAX variables' for the tests after it."""
    x, jmod, v, tmod = pair
    ref = jax.jit(_train_apply(jmod))(v, x)
    got = copy.deepcopy(tmod).train()(_nchw(x))
    _close(got.detach().permute(0, 2, 3, 1), ref, atol=_rel(ref))


def test_gradients_of_gamma_and_input_match_jax_grad(pair):
    """d/dgamma and d/dx of sum(out * w), w seeded, in train mode."""
    x, jmod, v, tmod = pair
    w = np.random.default_rng(8).normal(size=SHAPE).astype(np.float32)
    apply = _train_apply(jmod)

    def loss(gamma, x):
        params = dict(v["params"], gamma=gamma)
        return jnp.sum(apply({**v, "params": params}, x) * w)

    g_gamma, g_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        v["params"]["gamma"], jnp.asarray(x))
    xt = _nchw(x).requires_grad_()
    m = copy.deepcopy(tmod).train()
    (m(xt) * _nchw(w)).sum().backward()
    _close(m.gamma.grad, g_gamma, atol=_rel(g_gamma))
    _close(xt.grad.permute(0, 2, 3, 1), g_x, atol=_rel(g_x))


def test_weights_cross_both_ways_bit_identical(pair):
    _, _, v, tmod = pair
    back = jax_variables(tmod)
    flat = lambda t, p=(): ({p: t} if not isinstance(t, dict) else {
        k: a for key, sub in t.items() for k, a in flat(sub, p + (key,)).items()})
    want, got = flat(jax.tree_util.tree_map(np.asarray, v)), flat(back)
    assert sorted(got) == sorted(want)
    assert ("params", "gamma") in got
    for path, a in want.items():
        assert got[path].dtype == a.dtype and np.array_equal(got[path], a), path
    sd = state_dict_from_jax(back)
    assert torch.equal(sd["gamma"], tmod.gamma.detach())


def test_the_mega_flag_is_ignored_when_residual(pair, monkeypatch):
    """At an eligible shape (40 x 40 tokens, 4 bands of 400) the residual
    A2C2f with mega_kernel=True runs the staged modules, as the JAX module's
    route does; the same block without `residual` takes the mega route."""
    _, _, v, _ = pair
    mega = _load(attention.A2C2f(64, 64, **ARGS, mega_kernel=True), v)
    staged = _load(attention.A2C2f(64, 64, **ARGS), v)
    plain_args = dict(ARGS, residual=False, mega_kernel=True)
    control = attention.A2C2f(64, 64, **plain_args).eval()
    calls = []
    real = attention.a2c2f_fused
    monkeypatch.setattr(attention, "a2c2f_fused",
                        lambda *a: calls.append(a[2:]) or real(*a))
    big = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 64, 40, 40)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(mega(big), staged(big))
        assert calls == []
        control(big)
    assert calls == [(2, 4, 1)]            # n_stages, area, heads


def test_gamma_is_decayed_and_replicated(pair):
    _, _, _, tmod = pair
    groups = parameter_groups(tmod)
    assert any(p is tmod.gamma for p in groups["decay"])
    assert not any(p is tmod.gamma for p in groups["bias"] + groups["nodecay"])
    mesh = meshlib.Mesh(rank=0, size=2, device=torch.device("cpu"),
                        backend="gloo", n_model=2)
    rules = meshlib.param_sharding_rules(mesh, tmod, min_size=1)
    assert rules["gamma"].axis is None
    assert rules["cv2.conv.weight"].axis == "model"
