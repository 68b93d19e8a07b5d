"""PyTorch port: the whole serving slice against the JAX package, f32 CPU.

yolov12n-seg (4 ch, nc=1) at 64^2 and batch 2, random JAX weights (see
`jax_variables`) carried across by `state_dict_from_jax`: the forward
pass, the encoder slice (taps / stop_at) and NMS on JAX's own predictions.
The letterbox, mask ops and the Predictor end to end are in
test_torch_port_predictor.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.nn.heads import warm_start_detect_bias as jax_warm_start
from yolou_tpu.ops.nms import non_max_suppression as jax_nms
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.ops.nms import non_max_suppression
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .torch_threads import one_torch_thread  # noqa: F401

IMGSZ = 64


def jax_variables(jmod, seed=0):
    """Random JAX variables for `jmod` drawn with numpy (shapes from
    eval_shape; compiling flax's init takes longer than the tests): kernels
    N(0, 1/fan_in), biases N(0, .1), BN scale 1 + N(0, .1), running mean
    N(0, .1), running variance in [1, 1.5) (activations stay of order 1
    through 22 layers); then the warm-started head bias, so NMS has work."""
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, IMGSZ, IMGSZ, 4)), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name == "var":
            a = rng.random(s.shape) * 0.5 + 1.0
        elif name == "scale":
            a = 1.0 + rng.normal(0, 0.1, s.shape)
        else:                                   # bias, mean
            a = rng.normal(0, 0.1, s.shape)
        return a.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(draw, shapes)
    return {"params": jax.device_get(jax_warm_start(v["params"])),
            "batch_stats": v["batch_stats"]}


@pytest.fixture(scope="module")
def models():
    jmod = build_yolo_jax("yolov12", "n", nc=1, ch=4, task="segment")
    variables = jax_variables(jmod)
    tmod = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu")
    tmod.load_state_dict(state_dict_from_jax(variables), strict=True)
    return jmod, variables, tmod


@pytest.fixture(scope="module")
def forward_pair(models):
    jmod, variables, tmod = models
    x = np.random.default_rng(1).random((2, IMGSZ, IMGSZ, 4), np.float32)
    ref = jax.jit(lambda v, x: jmod.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    return jax.device_get(ref), out


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_forward_matches_jax(forward_pair):
    """raw maps, preds, mask coefficients, protos within 1e-4 (f32 through
    22 layers; boxes are pixels up to ~2x the 64 input)."""
    ref, out = forward_pair
    assert len(out.raw) == 3
    for rt, rj in zip(out.raw, ref.raw):
        _close(rt.permute(0, 2, 3, 1), rj, 1e-4)
    _close(out.preds, ref.preds, 1e-4)
    _close(out.mask_coefs, ref.mask_coefs, 1e-4)
    _close(out.protos.permute(0, 2, 3, 1), ref.protos, 1e-4)


def test_taps_and_stop_at_match_jax(models):
    """The encoder slice the YOLO-Seg++ decoder takes: taps (2, 4), stop
    before layer 5, no head outputs."""
    jmod, variables, tmod = models
    x = np.random.default_rng(2).random((2, IMGSZ, IMGSZ, 4), np.float32)
    ref = jmod.apply(variables, x, train=False, taps=(2, 4), stop_at=5)
    with torch.no_grad():
        out = tmod(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()),
                   taps=(2, 4), stop_at=5)
    assert out.preds is None and out.raw == () and sorted(out.taps) == [2, 4]
    for i in (2, 4):
        _close(out.taps[i].permute(0, 2, 3, 1), ref.taps[i], 1e-5)


def test_nms_on_jax_preds_is_identical(forward_pair):
    ref, _ = forward_pair
    want = jax_nms(jnp.asarray(ref.preds), nc=1)
    got = non_max_suppression(torch.from_numpy(np.array(ref.preds)), nc=1)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.valid.sum()) > 0
