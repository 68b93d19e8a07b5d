"""PyTorch port: the blocks of the yolov8 and yolo11 families against the
JAX package, f32 on the CPU.

The blocks these families add (C2f, SPPF, PSAAttention, PSABlock, C2PSA)
in eval and in train mode (outputs and the updated running statistics),
PSABlock's gradients against `jax.grad`, the legacy (v8) and modern class
branches of the Segment head, the parsed specs, and YOLO-Seg++ over both
encoders. JAX weights are drawn with numpy and carried across by
`state_dict_from_jax`. Tolerances: blocks and gradients 1e-5 absolute (f32
on both sides, sums in another order); running statistics 1e-6; YOLO-Seg++
1e-5 absolute plus 1e-4 relative, the JAX package's own golden tolerance
for whole graphs. The whole graphs and the Predictor are in
`test_torch_port_families_graphs.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu.nn import attention as jattn
from yolou_tpu.nn import blocks as jblocks
from yolou_tpu.nn import heads as jheads
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.models.yolo import parse_model_spec
from yolou_tpu_torch.nn import attention, blocks, heads
from yolou_tpu_torch.tools import convert
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from .test_torch_port_layers import _close, _init, _load, _nchw
from .test_torch_port_segpp import _draw
from .test_torch_port_slice import IMGSZ
from .test_torch_port_trainer import _leaves_close, _train_pair
from .torch_threads import one_torch_thread  # noqa: F401

FAMILIES = ("yolov8", "yolo11")


def _block_pair(name):
    """(JAX module, port module, NHWC input) for each block case. The PSA
    cases run at c = 128 where they have two heads, so that a permuted
    qkv layout would show in the second head."""
    rng = np.random.default_rng(len(name))

    def x(c, hw=6):
        return rng.normal(0, 0.5, (2, hw, hw, c)).astype(np.float32)

    return {
        "C2f shortcut": (jblocks.C2f(48, n=2, shortcut=True),
                         blocks.C2f(32, 48, n=2, shortcut=True), x(32)),
        "C2f": (jblocks.C2f(48, n=2, shortcut=False),
                blocks.C2f(32, 48, n=2, shortcut=False), x(32)),
        "SPPF": (jblocks.SPPF(40, 5), blocks.SPPF(48, 40, 5), x(48, 7)),
        "PSAAttention h1": (jattn.PSAAttention(64, 1),
                            attention.PSAAttention(64, 1), x(64)),
        "PSAAttention h2": (jattn.PSAAttention(128, 2),
                            attention.PSAAttention(128, 2), x(128)),
        "PSABlock": (jattn.PSABlock(128, 2), attention.PSABlock(128, 0.5, 2),
                     x(128, 4)),
        "C2PSA": (jattn.C2PSA(256, n=1), attention.C2PSA(192, 256, n=1),
                  x(192, 4)),
    }[name]


BLOCKS = ("C2f shortcut", "C2f", "SPPF", "PSAAttention h1",
          "PSAAttention h2", "PSABlock", "C2PSA")


@pytest.mark.parametrize("name", BLOCKS)
def test_block_eval_matches_jax(name):
    jmod, tmod, x = _block_pair(name)
    v = _init(jmod, jnp.asarray(x), seed=3)
    ref = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(v, x)
    tmod = _load(tmod, v)
    with torch.no_grad():
        _close(tmod(_nchw(x)).permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("name", [b for b in BLOCKS if b != "SPPF"])
def test_block_train_mode_matches_jax(name):
    """Batch statistics in every BatchNorm, the running statistics updated
    with flax's biased variance (`blocks.BatchNorm2d`)."""
    jmod, tmod, x = _block_pair(name)
    _train_pair(jmod, tmod, x, seed=5)


def _conv_bn_silu_f64(conv, x):
    """A port Conv in train mode evaluated in float64 (two-pass batch
    variance)."""
    w = conv.conv.weight.double()
    y = torch.nn.functional.conv2d(x, w, padding=conv.conv.padding)
    m = y.mean((0, 2, 3), keepdim=True)
    var = (y - m).square().mean((0, 2, 3), keepdim=True)
    y = ((y - m) * torch.rsqrt(var + conv.bn.eps)
         * conv.bn.weight.double()[:, None, None]
         + conv.bn.bias.double()[:, None, None])
    return torch.nn.functional.silu(y)


def test_sppf_train_mode_matches_jax_and_float64():
    """SPPF in train mode. The max-pools leave cv2's input with a mean
    large beside its spread, and flax's BatchNorm takes the batch variance
    as E[x^2] - E[x]^2 in f32 (`use_fast_variance`), which loses digits
    there: the JAX output is off a float64 evaluation of the same function
    by up to ~1e-4 on this input, where the port's (torch's two-pass
    variance) stays within 1e-5. So the outputs are held against float64
    within 1e-5, and against JAX within 1e-5 plus JAX's own distance from
    float64; parameters and running statistics against JAX as for the
    other blocks."""
    jmod, tmod, x = _block_pair("SPPF")
    v = _init(jmod, jnp.asarray(x), seed=5)
    ref, upd = jmod.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    tmod.train()
    out = tmod(_nchw(x)).detach().permute(0, 2, 3, 1).numpy()
    with torch.no_grad():
        ys = [_conv_bn_silu_f64(tmod.cv1, _nchw(x).double())]
        ys.extend(torch.nn.functional.max_pool2d(ys[-1], 5, 1, 2)
                  for _ in range(3))
        f64 = _conv_bn_silu_f64(tmod.cv2, torch.cat(ys, 1))
    f64 = f64.permute(0, 2, 3, 1).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, f64, atol=1e-5, rtol=0)
    assert np.all(np.abs(out - ref) <= 1e-5 + np.abs(ref - f64))
    got = convert.jax_variables(tmod)
    _leaves_close(got["batch_stats"], upd["batch_stats"], 1e-6, "batch_stats")
    _leaves_close(got["params"], v["params"], 0, "params")


def test_psa_qkv_layout_is_head_major():
    """Channel h*(2kd+hd) + j of the qkv conv is head h's q (j < kd), k
    (kd <= j < 2kd) or v (ultralytics' layout): doubling head 1's v doubles
    the second half of the attention output's channels (proj's input, pe
    zeroed) and leaves the first half as it was."""
    m = attention.PSAAttention(128, 2).eval()
    kd, hd = m.key_dim, m.head_dim
    assert (kd, hd, m.qkv.conv.out_channels) == (32, 64, 256)
    x = torch.randn(1, 128, 3, 3, generator=torch.Generator().manual_seed(0))
    seen = {}
    m.proj.register_forward_hook(lambda mod, a, out: seen.update(x=a[0]))
    with torch.no_grad():
        m.pe.conv.weight.zero_()
        m.pe.bn.bias.zero_()
        m.pe.bn.running_mean.zero_()
        m(x)
        before = seen["x"]
        v1 = slice(2 * (2 * kd + hd) - hd, 2 * (2 * kd + hd))
        m.qkv.bn.weight[v1] *= 2
        m.qkv.bn.bias[v1] *= 2
        m(x)
    after = seen["x"]
    torch.testing.assert_close(after[:, :hd], before[:, :hd], rtol=0, atol=0)
    torch.testing.assert_close(after[:, hd:], 2 * before[:, hd:])


def test_psablock_gradients_match_jax_grad():
    """The input's and every parameter's gradient of sum(w * out) in train
    mode against `jax.grad` of the JAX module (plain autograd through the
    attention on both sides)."""
    jmod = jattn.PSABlock(128, 2)
    tmod = attention.PSABlock(128, 0.5, 2)
    rng = np.random.default_rng(8)
    x = rng.normal(0, 0.5, (2, 4, 4, 128)).astype(np.float32)
    w = rng.normal(0, 0.1, (2, 4, 4, 128)).astype(np.float32)
    v = _init(jmod, jnp.asarray(x), seed=9)

    def loss(params, xx):
        out, _ = jmod.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, xx,
                            train=True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"],
                                                     jnp.asarray(x))
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    tmod.train()
    xt = _nchw(x).requires_grad_(True)
    (tmod(xt) * _nchw(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(gx), atol=1e-5, rtol=0)
    grads = {n: p.grad for n, p in tmod.named_parameters()}
    got = convert.jax_variables(tmod, grads)["params"]
    _leaves_close(got, jax.device_get(gp), 1e-5, "grad")


@pytest.mark.parametrize("legacy", [True, False])
def test_segment_head_matches_jax(legacy):
    rng = np.random.default_rng(10)
    ch = (64, 128, 256)
    feats = [rng.normal(size=(2, hw, hw, c)).astype(np.float32)
             for c, hw in zip(ch, (8, 4, 2))]
    jmod = jheads.Segment(nc=3, nm=32, npr=64, reg_max=16, legacy=legacy)
    v = _init(jmod, [jnp.asarray(f) for f in feats])
    raw, mc, protos = jax.jit(lambda v, f: jmod.apply(v, f, train=False))(
        v, [jnp.asarray(f) for f in feats])
    tmod = _load(heads.Segment(3, 32, 64, ch, 16, legacy), v,
                 allow_missing=["dfl.conv.weight"])
    names = tmod.state_dict()
    assert ("cv3.0.0.conv.weight" in names) == legacy
    assert ("cv3.0.0.0.conv.weight" in names) != legacy
    with torch.no_grad():
        raw_t, mc_t, protos_t = tmod([_nchw(f) for f in feats])
    for rj, rt in zip(raw, raw_t):
        _close(rt.permute(0, 2, 3, 1), rj)
    _close(mc_t, mc)
    _close(protos_t.permute(0, 2, 3, 1), protos)


@pytest.mark.parametrize("arch", FAMILIES)
def test_spec_matches_jax(arch):
    """Every field of the JAX spec, for every scale; the port's spec also
    names its family and scale."""
    for variant in "nsmlx":
        for task in ("detect", "segment"):
            want = jax_spec(arch, variant, 80, 3, task)
            got = parse_model_spec(arch, variant, 80, 3, task)
            assert (got.arch, got.variant) == (arch, variant)
            for f in ("channels", "head_from", "strides", "nc", "task", "nm",
                      "npr", "reg_max", "legacy_head"):
                assert getattr(got, f) == getattr(want, f), (variant, f)
            assert [(r.frm, r.repeats, r.block, r.args)
                    for r in got.layers] == [
                (r.frm, r.repeats, r.block, r.args) for r in want.layers]
    assert parse_model_spec(arch).legacy_head == (arch == "yolov8")


@pytest.mark.parametrize("arch", FAMILIES)
def test_segpp_over_the_family_matches_jax(arch):
    """YOLO-Seg++ over the family's encoder: the decoder's skip widths
    follow the spec (yolov8n 32 / 64, yolo11n 64 / 128); the fused pass's
    mask logits and the encoder-slice pass on given logits."""
    spec = jax_spec(arch, "n", 1, 4, "detect")
    jmod = jsegpp.YOLOSegPP(spec=spec)
    shapes = jax.eval_shape(lambda: jmod.init(
        jax.random.key(0), jnp.zeros((1, IMGSZ, IMGSZ, 4)), train=False))
    v = _draw(shapes, seed=12)
    tmod = build_segpp(arch, "n", nc=1, ch=4, device="cpu")
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    skips = (tmod.decoder[2][0].cv1.conv.in_channels - 64,
             tmod.decoder[0][0].cv1.conv.in_channels - 1)
    assert skips == {"yolov8": (32, 64), "yolo11": (64, 128)}[arch]
    rng = np.random.default_rng(13)
    x = rng.random((2, IMGSZ, IMGSZ, 4), np.float32)
    logits = rng.random((2, IMGSZ // 8, IMGSZ // 8, 1), np.float32)
    apply = jax.jit(lambda v, x, lg: jmod.apply(v, x, logits=lg,
                                                 train=False)[0])
    for given in (None, logits):
        want = apply(v, jnp.asarray(x), given)
        with torch.no_grad():
            got, _ = tmod(_nchw(x), None if given is None else _nchw(given))
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-5, rtol=1e-4)
