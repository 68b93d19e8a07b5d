"""PyTorch port: the YOLO-Seg++ decoder blocks, decoder and fused model
against the JAX modules, f32 on the CPU.

Random JAX variables (numpy draws, BatchNorm statistics included) cross
through `state_dict_from_jax`; inputs are numpy draws fed to both sides.
Tolerance 1e-4 absolute (f32 on both sides, sums in another order; the
model's mask logits pass through some thirty layers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu.nn import blocks as jblocks
from yolou_tpu_torch.models import segpp
from yolou_tpu_torch.nn import blocks
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_golden import TSegPPDecoder, _randomize, _sd
from .test_torch_port_layers import _close, _init, _load, _nchw
from .torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _draw(shapes, seed):
    """Random values for a tree of shapes, as `_init` draws them."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = path[-1].key
        if name == "kernel":
            a = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name == "var":
            a = rng.random(s.shape) * 0.5 + 0.5
        elif name == "scale":
            a = 1.0 + rng.normal(0, 0.1, s.shape)
        else:
            a = rng.normal(0, 0.1, s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


BLOCKS = {
    "lightconv": (lambda: jblocks.LightConv(24, 3),
                  lambda: blocks.LightConv(16, 24, 3)),
    "ghostconv": (lambda: jblocks.GhostConv(24, 1, 1),
                  lambda: blocks.GhostConv(16, 24, 1, 1)),
    "ghostconv-noact": (lambda: jblocks.GhostConv(32, 3, 1, act=False),
                        lambda: blocks.GhostConv(16, 32, 3, 1, act=False)),
    "ghostbottleneck-s1": (lambda: jblocks.GhostBottleneck(16),
                           lambda: blocks.GhostBottleneck(16, 16)),
    "ghostbottleneck-s1-wider": (lambda: jblocks.GhostBottleneck(32),
                                 lambda: blocks.GhostBottleneck(16, 32)),
    "ghostbottleneck-s2": (lambda: jblocks.GhostBottleneck(32, 3, 2),
                           lambda: blocks.GhostBottleneck(16, 32, 3, 2)),
    "c3ghost": (lambda: jblocks.C3Ghost(32, 2),
                lambda: blocks.C3Ghost(16, 32, 2)),
    "eca": (lambda: jblocks.ECA(), lambda: blocks.ECA()),
    "singlelightconv": (lambda: jblocks.SingleLightConv(24),
                        lambda: blocks.SingleLightConv(16, 24)),
    "singlelightconv-same": (lambda: jblocks.SingleLightConv(16),
                             lambda: blocks.SingleLightConv(16, 16)),
    "doublelightconv": (lambda: jblocks.DoubleLightConv(24),
                        lambda: blocks.DoubleLightConv(16, 24)),
    "doublelightconv-same": (lambda: jblocks.DoubleLightConv(16, 5, 3),
                             lambda: blocks.DoubleLightConv(16, 16, 5, 3)),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_decoder_block_matches_jax(name):
    make_jax, make_torch = BLOCKS[name]
    x = np.random.default_rng(1).normal(size=(2, 8, 10, 16)).astype(np.float32)
    jmod = make_jax()
    v = _init(jmod, jnp.asarray(x), seed=len(name))
    ref = jmod.apply(v, jnp.asarray(x), train=False)
    tmod = _load(make_torch(), v)
    with torch.no_grad():
        got = tmod(_nchw(x))
    _close(got.permute(0, 2, 3, 1), ref, atol=ATOL)


@pytest.mark.parametrize("out_hw", [(16, 20), (24, 30), (5, 7)])
def test_upsample_bilinear_matches_jax(out_hw):
    x = np.random.default_rng(2).normal(size=(2, 8, 10, 3)).astype(np.float32)
    ref = jblocks.upsample_bilinear_torch(jnp.asarray(x), out_hw)
    got = blocks.upsample_bilinear_torch(_nchw(x), out_hw)
    if out_hw[0] >= 8:        # upsampling; jax antialiases when shrinking
        _close(got.permute(0, 2, 3, 1), ref, atol=1e-5)
    assert got.shape == (2, 3) + out_hw


def _decoder_inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(2, 16, 16, 64)).astype(np.float32),
            rng.normal(size=(2, 8, 8, 128)).astype(np.float32),
            rng.random((2, 8, 8, 1)).astype(np.float32))


@pytest.mark.parametrize("use_logits", [True, False])
def test_decoder_matches_jax(use_logits):
    s2, s4, lg = _decoder_inputs()
    jmod = jsegpp.SegPPDecoder(use_logits=use_logits)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.asarray(s2), jnp.asarray(s4), jnp.asarray(lg),
        train=False))
    v = _draw(shapes, seed=4)
    ref = jmod.apply(v, jnp.asarray(s2), jnp.asarray(s4), jnp.asarray(lg),
                     train=False)
    tmod = segpp.SegPPDecoder(use_logits=use_logits)
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    with torch.no_grad():
        got = tmod.eval()(_nchw(s2), _nchw(s4), _nchw(lg))
    assert got.dtype == torch.float32 and got.shape == (2, 1, 64, 64)
    _close(got.permute(0, 2, 3, 1), ref, atol=ATOL)


def test_decoder_carries_the_reference_names_and_loads_its_state_dict():
    """The literal reference module tree (decoder.{i}.{j}..., output.*): the
    same key set and shapes, a strict load, and the same output."""
    ref = _randomize(TSegPPDecoder())
    sd = {k: torch.from_numpy(np.array(v)) for k, v in _sd(ref).items()}
    ours = segpp.SegPPDecoder(use_logits=True)
    want = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in ours.state_dict().items()}
    assert got == want
    for k in ("decoder.0.0.cv1.conv.weight", "decoder.2.1.conv.weight",
              "decoder.1.1.conv.0.conv1.conv.weight",
              "decoder.3.1.residual_conv.weight", "output.bias"):
        assert k in got
    ours.load_state_dict(sd, strict=True)
    s2, s4, lg = (_nchw(a) for a in _decoder_inputs(seed=5))
    with torch.no_grad():
        _close(ours.eval()(s2, s4, lg), ref.eval()(s2, s4, lg).numpy(),
               atol=ATOL)
    with pytest.raises(ValueError, match="conditioning"):
        ours(s2, s4)


@pytest.fixture(scope="module")
def model_pair():
    """JAX YOLOSegPP (yolov12n, 4 ch, with and without the conditioning map)
    with random variables and the port's over the converted weights."""
    spec = jax_spec("yolov12", "n", 1, 4, "detect")
    out = {}
    for use_logits in (True, False):
        jmod = jsegpp.YOLOSegPP(spec=spec, use_logits=use_logits)
        shapes = jax.eval_shape(lambda: jmod.init(
            jax.random.key(0), jnp.zeros((1, 64, 64, 4)), train=False))
        v = _draw(shapes, seed=6)
        # running variances in [1, 1.5): activations stay of order 1
        v["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.5 if p[-1].key == "var" else a,
            v["batch_stats"])
        tmod = segpp.build_segpp("yolov12", "n", nc=1, ch=4,
                                 use_logits=use_logits, device="cpu")
        tmod.load_state_dict(state_dict_from_jax(v), strict=True)
        out[use_logits] = (jmod, v, tmod)
    return out


@pytest.mark.parametrize("use_logits", [True, False])
def test_fused_pass_matches_jax(model_pair, use_logits):
    jmod, v, tmod = model_pair[use_logits]
    x = np.random.default_rng(7).random((2, 64, 64, 4), np.float32)
    ref_mask, ref_out = jax.jit(
        lambda v, x: jmod.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        mask, out = tmod(_nchw(x))
    assert mask.shape == (2, 1, 64, 64) and mask.dtype == torch.float32
    _close(mask.permute(0, 2, 3, 1), ref_mask, atol=ATOL)
    # boxes of random weights reach several hundred pixels, where one f32
    # ulp is 3e-5: 1e-4 absolute plus 1e-6 relative
    np.testing.assert_allclose(out.preds.numpy(), np.asarray(ref_out.preds),
                               atol=ATOL, rtol=1e-6)
    assert sorted(out.taps) == [2, 4]
    assert float(np.asarray(ref_mask).std()) > 1e-3     # a live decoder


def test_encoder_slice_mode_matches_jax(model_pair):
    jmod, v, tmod = model_pair[True]
    rng = np.random.default_rng(8)
    x = rng.random((2, 64, 64, 4), np.float32)
    lg = rng.random((2, 8, 8, 1), np.float32)
    ref_mask, ref_out = jmod.apply(v, x, jnp.asarray(lg), train=False)
    with torch.no_grad():
        mask, out = tmod(_nchw(x), _nchw(lg))
    _close(mask.permute(0, 2, 3, 1), ref_mask, atol=ATOL)
    assert out.preds is None and out.raw == () and ref_out.preds is None


def test_encoder_is_frozen(model_pair):
    """No gradient reaches the encoder, and its BatchNorm buffers do not move
    under train(); the decoder's parameters all get gradients."""
    _, _, tmod = model_pair[True]
    before = {k: v.clone() for k, v in tmod.state_dict().items()}
    tmod.train()
    try:
        assert tmod.training and not any(
            m.training for m in tmod.yolo.modules())
        assert tmod.decoder[0][0].cv1.bn.training
        x = torch.from_numpy(np.random.default_rng(9).random(
            (2, 4, 64, 64), np.float32))
        mask, _ = tmod(x)
        mask.square().mean().backward()
    finally:
        tmod.eval()
    assert all(p.grad is None for p in tmod.yolo.parameters())
    dec = list(tmod.decoder_parameters())
    assert dec and all(p.grad is not None for p in dec)
    assert len(dec) == sum(1 for n, _ in tmod.named_parameters()
                           if not n.startswith("yolo."))
    after = tmod.state_dict()
    moved = [k for k in after if not torch.equal(after[k], before[k])]
    assert moved and all(not k.startswith("yolo.") for k in moved)
    for p in tmod.parameters():
        p.grad = None
    tmod.load_state_dict(before)


def test_reference_checkpoint_fills_encoder_decoder_and_output(model_pair):
    _, _, tmod = model_pair[True]
    full = tmod.state_dict()
    ref = {}
    for k, v in full.items():
        if k.startswith("yolo.model."):
            i, _, rest = k[len("yolo.model."):].partition(".")
            if int(i) < segpp.ENCODER_LAYERS:
                ref[f"encoder.{i}.{rest}"] = v + 1 if v.is_floating_point() else v
        else:
            ref[k] = v + 1 if v.is_floating_point() else v
    fresh = segpp.build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    missing, unexpected = fresh.load_reference_state_dict(ref)
    assert not unexpected
    assert missing and all(
        int(k[len("yolo.model."):].split(".")[0]) >= segpp.ENCODER_LAYERS
        for k in missing)
    got = fresh.state_dict()
    assert torch.equal(got["yolo.model.4.cv2.conv.weight"],
                       full["yolo.model.4.cv2.conv.weight"] + 1)
    assert torch.equal(got["output.bias"], full["output.bias"] + 1)


def test_build_segpp_without_a_device_means_the_gpu():
    if torch.cuda.is_available():
        m = segpp.build_segpp("yolov12", "n", nc=1, ch=4)
        assert next(m.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            segpp.build_segpp("yolov12", "n", nc=1, ch=4)
    a, b = (segpp.build_segpp("yolov12", "n", nc=1, ch=4, device="cpu",
                              seed=s) for s in (1, 1))
    assert all(torch.equal(v, b.state_dict()[k])
               for k, v in a.state_dict().items())
