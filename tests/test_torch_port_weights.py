"""PyTorch port: weights cross from the JAX package unchanged.

`yolou_tpu_torch.tools.convert.state_dict_from_jax` must equal the JAX
package's own exporter (`jax_to_torch_state_dict`) key for key and bit for
bit, load into the port with strict=True, and the port's module tree must
carry the released ultralytics key set (tests/fixtures).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.models.segpp import YOLOSegPP as JaxYOLOSegPP
from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.models.yolo import parse_model_spec as jax_spec
from yolou_tpu.tools.torch2jax import jax_to_torch_state_dict
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.nn.attention import aattn_qkv_permutation
from yolou_tpu_torch.tools.convert import (SEGPP_PREFIX_MAP, jax_variables,
                                           state_dict_from_jax)

from .torch_threads import one_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
# released listing and the published parameter-count range of each family
# (tests/test_released_keyset.py's)
RELEASED = {
    "yolov12": ("yolov12n_seg_state_dict.txt", 2.80e6, 2.92e6),
    "yolov8": ("yolov8n_seg_state_dict.txt", 3.35e6, 3.47e6),
    "yolo11": ("yolo11n_seg_state_dict.txt", 2.83e6, 2.95e6),
}


@pytest.fixture(scope="module")
def variables():
    """yolov12n-seg (4 ch, nc=1) JAX variables, every leaf a distinct
    random draw (shapes from eval_shape; compiling flax's init is slow)."""
    model = build_yolo_jax("yolov12", "n", nc=1, ch=4, task="segment")
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 4)), train=False))
    rng = np.random.default_rng(0)
    return jax.tree_util.tree_map(
        lambda s: rng.random(s.shape, np.float32) + 0.5, shapes)


def test_state_dict_equals_jax_exporter_bit_for_bit(variables):
    ours = state_dict_from_jax(variables)
    theirs = jax_to_torch_state_dict(variables)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        o = ours[k].numpy()
        assert o.dtype == v.dtype and o.shape == v.shape, k
        assert np.array_equal(o, v), k


def test_state_dict_loads_strict(variables):
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    sd = state_dict_from_jax(variables)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for k, v in sd.items():
        assert torch.equal(got[k], v), k


def _fixture(name):
    out = {}
    with open(os.path.join(FIXTURES, name)) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            name, _, shape = line.strip().partition(" ")
            out[name] = tuple(int(s) for s in shape.split(",") if s)
    return out


@pytest.mark.parametrize("arch", list(RELEASED))
def test_module_tree_matches_released_keyset(arch):
    """Name for name and shape for shape the released n-scale segment
    checkpoint (nc=80, 3 channels), and the learned parameters within the
    published count."""
    name, lo, hi = RELEASED[arch]
    model = build_yolo(arch, "n", nc=80, ch=3, task="segment", device="cpu")
    ours = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert ours == _fixture(name)
    learned = sum(p.numel() for p in model.parameters() if p.requires_grad)
    assert lo < learned < hi


@pytest.mark.parametrize("c", [96, 192, 384])
def test_qkv_permutation_is_a_permutation_into_role_major(c):
    perm = aattn_qkv_permutation(c)
    assert sorted(perm.tolist()) == list(range(c))
    dim, hd = c // 3, 32
    # our channel role*dim + h*hd + d comes from ultralytics h*3*hd + role*hd + d
    for role in range(3):
        for h in range(dim // hd):
            assert perm[role * dim + h * hd] == h * 3 * hd + role * hd


def test_seeded_init_is_deterministic():
    a, b, c = (build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                          device="cpu", seed=seed) for seed in (3, 3, 4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "model.0.conv.weight"
    assert not torch.equal(sa[w], sc[w])
    assert torch.equal(sa["model.21.dfl.conv.weight"].flatten(),
                       torch.arange(16, dtype=torch.float32))


def test_build_yolo_without_a_device_means_the_gpu():
    """No `device` is the GPU, never silently the CPU: where there is no
    CUDA device the call raises and names the way to ask for the CPU."""
    if torch.cuda.is_available():
        model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment")
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build_yolo("yolov12", "n", nc=1, ch=4, task="segment")


@pytest.fixture(scope="module")
def segpp_variables():
    """YOLOSegPP (yolov12n, 4 ch) JAX variables, every leaf a distinct random
    draw: the YOLO graph under `yolo`, the decoder under `decoder`."""
    model = JaxYOLOSegPP(spec=jax_spec("yolov12", "n", 1, 4, "detect"))
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 4)), train=False))
    rng = np.random.default_rng(1)
    return jax.tree_util.tree_map(
        lambda s: rng.random(s.shape, np.float32) + 0.5, shapes)


@pytest.mark.parametrize("prefix_map", [None, SEGPP_PREFIX_MAP])
def test_segpp_state_dict_equals_jax_exporter_bit_for_bit(segpp_variables,
                                                          prefix_map):
    ours = state_dict_from_jax(segpp_variables, prefix_map)
    theirs = jax_to_torch_state_dict(segpp_variables, prefix_map=prefix_map)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        o = ours[k].numpy()
        assert o.dtype == v.dtype and o.shape == v.shape, k
        assert np.array_equal(o, v), k
    tops = {k.split(".")[0] for k in ours}
    assert tops == ({"yolo", "decoder", "output"} if prefix_map is None
                    else {"encoder", "decoder", "output"})
    assert ours["decoder.0.1.conv.weight"].shape == (1, 1, 3)   # ECA Conv1d


def test_segpp_state_dict_loads_strict_and_converts_back(segpp_variables):
    model = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    sd = state_dict_from_jax(segpp_variables)
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    for pm in (None, SEGPP_PREFIX_MAP):
        # a state_dict under the reference's names, renamed back to the
        # model's before the way back
        unmap = {theirs: ours for ours, theirs in (pm or {}).items()}
        named = {next((o + k[len(t):] for t, o in unmap.items()
                       if k.startswith(t)), k): v
                 for k, v in state_dict_from_jax(segpp_variables, pm).items()}
        back = jax_variables(model, named)
        flat = jax.tree_util.tree_leaves_with_path(back)
        want = dict(jax.tree_util.tree_leaves_with_path(segpp_variables))
        assert len(flat) == len(want)
        for path, leaf in flat:
            assert np.array_equal(leaf, want[path]), path
