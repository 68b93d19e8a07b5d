"""PyTorch port: the training attention entry points against the JAX
package's Pallas kernels, f32 on the CPU.

The JAX `area_attention_fused` / `area_attention` run in interpret mode,
their default off a TPU; the port's entry points run the plain version on CPU
tensors with the hand-written backward the training step uses. Outputs
within 1e-5, gradients within 1e-4 (f32 sums in another order over up to 48
keys, values of order 1). The eval kernel `area_attention_qkv_fused` is
differentiable too: its backward (the one the card runs) against `jax.vjp`
of the JAX kernel in interpret mode, within 1e-4; the whole-A2C2f kernel,
which has no backward, refuses inputs that require grad.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.ops.pallas_attn import area_attention as jax_area_attention
from yolou_tpu.ops.pallas_attn import \
    area_attention_fused as jax_area_attention_fused
from yolou_tpu.ops.pallas_attn import \
    area_attention_qkv_fused as jax_area_attention_qkv_fused
from yolou_tpu_torch import kernels
from yolou_tpu_torch.kernels.a2c2f import a2c2f_fused
from yolou_tpu_torch.kernels.attention import (area_attention,
                                               area_attention_fused,
                                               area_attention_fused_plain,
                                               area_attention_plain,
                                               area_attention_qkv_fused)

CASES = [(4, 48, 64, 2), (2, 25, 128, 4), (6, 16, 32, 1)]


def _inputs(g, n, c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(g, n, c)).astype(np.float32) for _ in range(4)]


def _entry_points(heads, single):
    if single:
        return jax_area_attention, area_attention
    return (lambda q, k, v: jax_area_attention_fused(q, k, v, heads),
            lambda q, k, v: area_attention_fused(q, k, v, heads))


def _cases():
    for g, n, c, heads in CASES:
        yield pytest.param(g, n, c, heads, False, id=f"fused-{g}x{n}x{c}h{heads}")
    yield pytest.param(6, 16, 32, 1, True, id="single-6x16x32")


@pytest.mark.parametrize("g,n,c,heads,single", _cases())
def test_forward_matches_jax_kernel(g, n, c, heads, single):
    q, k, v, _ = _inputs(g, n, c, seed=n)
    jfn, tfn = _entry_points(heads, single)
    want = np.asarray(jfn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tfn(*(torch.from_numpy(t) for t in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("g,n,c,heads,single", _cases())
def test_gradients_match_jax_vjp(g, n, c, heads, single):
    q, k, v, do = _inputs(g, n, c, seed=n + 1)
    jfn, tfn = _entry_points(heads, single)
    _, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(tfn(tq, tk, tv), (tq, tk, tv),
                              torch.from_numpy(do))
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("g,n,c,heads,single", _cases())
def test_handwritten_backward_matches_autograd_of_plain(g, n, c, heads,
                                                        single):
    q, k, v, do = _inputs(g, n, c, seed=n + 2)
    _, tfn = _entry_points(heads, single)
    plain = (area_attention_plain if single else
             lambda q, k, v: area_attention_fused_plain(q, k, v, heads))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    tdo = torch.from_numpy(do)
    got = torch.autograd.grad(tfn(tq, tk, tv), (tq, tk, tv), tdo)
    want = torch.autograd.grad(plain(tq, tk, tv), (tq, tk, tv), tdo)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0,
                                   err_msg=f"d{name}")


def test_bfloat16_plain_rounds_probabilities_like_the_jax_reference():
    """bf16 inputs: the plain version follows the JAX reference (softmax in
    f32, probabilities rounded to bf16, f32 accumulation) within one bf16
    step of outputs of order 1."""
    from yolou_tpu.ops.pallas_attn import area_attention_fused_reference
    q, k, v, _ = _inputs(3, 40, 64, seed=9)
    want = np.asarray(area_attention_fused_reference(
        *(jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)), 2
    ).astype(jnp.float32))
    got = area_attention_fused_plain(
        *(torch.from_numpy(t).bfloat16() for t in (q, k, v)), 2)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=0)


QKV_CASES = [(4, 25, 64, 2), (2, 25, 128, 4), (3, 17, 32, 1)]


def _qkv_inputs(g, n, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(g, n, c)).astype(np.float32)
    w = rng.normal(0, 0.5 / np.sqrt(c), (c, 3 * c)).astype(np.float32)
    b = rng.normal(0, 0.1, (3 * c,)).astype(np.float32)
    do, dv = (rng.normal(size=(g, n, c)).astype(np.float32)
              for _ in range(2))
    return x, w, b, do, dv


@pytest.mark.parametrize("cotangent", ["o", "v", "both"])
@pytest.mark.parametrize("g,n,c,heads", QKV_CASES)
def test_qkv_attention_gradients_match_jax_vjp(g, n, c, heads, cotangent):
    """(dx, dw, db) for a cotangent on the attention output o, on the value
    projection v (which feeds the positional conv) or on both, against
    `_aaq_bwd` through `jax.vjp`."""
    x, w, b, do, dv = _qkv_inputs(g, n, c, seed=g * n + c)
    if cotangent == "o":
        dv = np.zeros_like(dv)
    elif cotangent == "v":
        do = np.zeros_like(do)
    _, vjp = jax.vjp(lambda x, w, b: jax_area_attention_qkv_fused(
        x, w, b, heads, interpret=True), *map(jnp.asarray, (x, w, b[None])))
    want = vjp((jnp.asarray(do), jnp.asarray(dv)))
    tx, tw, tb = (torch.from_numpy(t).requires_grad_() for t in (x, w, b))
    o, v = area_attention_qkv_fused(tx, tw, tb, heads)
    assert o.grad_fn is not None and v.grad_fn is not None
    kernels.reset_launch_counts()
    got = torch.autograd.grad((o, v), (tx, tw, tb),
                              (torch.from_numpy(do), torch.from_numpy(dv)))
    assert kernels.backward_counts()["band_attention"] == 1
    for a, bw, name in zip(got, want, ("x", "w", "b")):
        np.testing.assert_allclose(a.numpy(), np.asarray(bw).reshape(a.shape),
                                   atol=1e-4, rtol=0, err_msg=f"d{name}")


def test_qkv_attention_takes_no_autograd_path_without_grad():
    """No input requiring grad, or grad mode off: the forward alone, outputs
    without a graph; the same values as through autograd."""
    x, w, b, _, _ = _qkv_inputs(2, 25, 64, seed=1)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    o, v = area_attention_qkv_fused(tx, tw, tb, 2)
    assert o.grad_fn is None and v.grad_fn is None
    with torch.no_grad():
        o2, _ = area_attention_qkv_fused(tx.clone().requires_grad_(), tw,
                                         tb, 2)
    assert o2.grad_fn is None
    o3, v3 = area_attention_qkv_fused(tx.clone().requires_grad_(), tw, tb, 2)
    assert torch.equal(o, o2) and torch.equal(o, o3.detach())
    assert torch.equal(v, v3.detach())


def test_a2c2f_refuses_inputs_that_require_grad():
    rng = np.random.default_rng(0)
    ws = [torch.from_numpy(rng.normal(0, 0.1, sh).astype(np.float32))
          for sh in [(8, 32), (32,)] + [(32, 96), (96,), (7, 7, 32), (32,),
                                        (32, 32), (32,), (32, 64), (64,),
                                        (64, 32), (32,)] * 2 + [(64, 16), (16,)]]
    x = torch.from_numpy(rng.normal(size=(1, 4, 4, 8)).astype(np.float32))
    want = a2c2f_fused(x, ws, 1, 1, 1)
    with pytest.raises(RuntimeError, match="a2c2f_fused is not differentiable"):
        a2c2f_fused(x.clone().requires_grad_(), ws, 1, 1, 1)
    with pytest.raises(RuntimeError, match="a2c2f_fused is not differentiable"):
        a2c2f_fused(x, [ws[0].clone().requires_grad_(), *ws[1:]], 1, 1, 1)
    with torch.no_grad():
        got = a2c2f_fused(x.clone().requires_grad_(), ws, 1, 1, 1)
    assert torch.equal(got, want)


def test_refusals_on_cpu():
    q = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="multiple of heads"):
        area_attention_fused(q, q, q, 3)
    with pytest.raises(ValueError, match="share a shape"):
        area_attention_fused(q, q[:, :4], q, 2)
    with pytest.raises(TypeError, match="share a dtype"):
        area_attention_fused(q, q.bfloat16(), q, 2)
    with pytest.raises(TypeError, match="dtype"):
        area_attention_fused(q.half(), q.half(), q.half(), 2)


def test_attention_profiler_runs_both_entry_points_on_the_cpu(capsys):
    """The `--attn` profiler (the single-head entry point's caller) at one
    image on the CPU: four implementations timed, the JAX tool's operation
    count, no kernel launch counted, a JSON line printed last; without a device
    it asks for the GPU and raises here."""
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.tools import profile_layers
    kernels.reset_launch_counts()
    profile_layers.main(["--attn", "--batch", "1", "--device", "cpu"])
    got = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert profile_layers.attention_shapes(8) == ((128, 400, 32),
                                                  (32, 400, 128))
    assert sorted(got) == ["kernel_banded", "kernel_fused", "plain_banded",
                           "plain_fused"]
    flops = 2 * 2 * (1 * 4 * 4) * 400 * 400 * 32     # the JAX tool's count
    for r in got.values():
        assert r["ms"] > 0
        np.testing.assert_allclose(r["tflops_effective"] * r["ms"] * 1e9,
                                   flops, rtol=1e-6)
    assert not any(kernels.launch_counts().values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            profile_layers.profile_attention_variants(batch=1)


def test_build_timer_cases_run_on_the_cpu():
    """`tools/time_builds.py`: every case it times (kernels A and C at the
    serving, evaluation, training and profiler shapes, `a2c2f` at layers 6
    and 8, kernel B at (8, 512) and (16, 512)) is a valid call of the
    package's wrapper; on the CPU each runs the plain version and counts no
    launch. Timing itself needs the card."""
    from yolou_tpu_torch import kernels
    from yolou_tpu_torch.tools import time_builds
    kernels.reset_launch_counts()
    calls = time_builds._calls(torch.device("cpu"))
    assert len(calls) == (len(time_builds.QKV_CASES)
                          + len(time_builds.ATTN_CASES)
                          + len(time_builds.A2C2F_CASES)
                          + len(time_builds.NMS_CASES))
    nms = dict(time_builds.NMS_CASES)
    for name, fn in calls.items():
        out = fn()
        first = out[0] if isinstance(out, tuple) else out
        if name in nms:               # a keep mask, some rows kept
            assert first.dtype == torch.bool, name
            assert tuple(first.shape) == nms[name] and bool(first.any())
            continue
        assert first.dtype == torch.bfloat16, name
        assert bool(torch.isfinite(first.float()).all()), name
    assert not any(kernels.launch_counts().values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            time_builds.main(["yolou_tpu_torch/csrc"])
