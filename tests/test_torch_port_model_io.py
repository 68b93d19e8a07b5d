"""PyTorch port: `.ckpt` model files, the msgpack codec under them, the JAX
variables derived from the port's modules, and the 4-channel stem
inflation, against the JAX package on the CPU.

The codec must write the bytes `flax.serialization.msgpack_serialize`
writes and read what it writes, exactly. The JAX variables derived with no
template must have the JAX init's paths and shapes and carry JAX weights
there and back bit for bit. Model files cross both ways: the port's
`save_model` read by the JAX package's `load_model` and the JAX package's
read by the port's, the forwards within 1e-5 (f32, random weights of order
1, 32^2 inputs).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from yolou_tpu.models import segpp as jsegpp
from yolou_tpu.models.yolo import build_yolo as jbuild_yolo
from yolou_tpu.models.yolo import inflate_stem_to_4ch as jinflate
from yolou_tpu.models.yolo import parse_model_spec as jspec
from yolou_tpu.utils import model_io as jmodel_io
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.models.yolo import build_yolo, inflate_stem_to_4ch
from yolou_tpu_torch.tools.convert import (_flatten, jax_variables,
                                           state_dict_from_jax)
from yolou_tpu_torch.utils import model_io, msgpack_lite

from .test_torch_port_slice import jax_variables as draw_variables
from .torch_threads import one_torch_thread  # noqa: F401

SIZE = 32


# ------------------------------------------------------------------ codec

def _trees():
    """(tree for flax, the same tree for the port): bf16 is an ml_dtypes
    array on flax's side and a torch.bfloat16 tensor on the port's."""
    rng = np.random.default_rng(0)
    bf = rng.normal(size=(3, 5)).astype(ml_dtypes.bfloat16)
    common = {
        "f32": rng.normal(size=(2, 3)).astype(np.float32),
        "f16": rng.normal(size=(4,)).astype(np.float16),
        "i32": rng.integers(-2**31, 2**31 - 1, (3, 2), dtype=np.int32),
        "i64": np.array([-2**63, 2**62, 0, -1], np.int64),
        "u8": rng.integers(0, 255, (2, 2, 3), dtype=np.uint8),
        "bool": rng.random((5,)) > 0.5,
        "zero_d": np.asarray(3.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "big": rng.normal(size=(70000,)).astype(np.float32),   # bin32
        "scalars": {"f32": np.float32(1.25), "i64": np.int64(-7),
                    "f64": np.float64(0.1), "b": np.bool_(True)},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                 -2**63],
        "floats": [0.0, -1.5, 1e300, float("inf")],
        "str": "meta", "long_str": "x" * 40, "str16": "y" * 300,
        "none": None, "flags": [True, False], "bytes": b"\x00\x01",
        "map16": {f"k{i:02d}": i for i in range(20)},
        "nested": {"a": {"b": {"c": np.arange(3, dtype=np.int32)}}},
    }
    ours = dict(common, bf16=torch.from_numpy(
        bf.view(np.int16).copy()).view(torch.bfloat16))
    return dict(common, bf16=bf), ours


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same(a, b)
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert type(got) is type(want) and got == want


def test_codec_writes_flax_bytes():
    theirs, ours = _trees()
    assert msgpack_lite.packb(ours) == serialization.msgpack_serialize(theirs)


def test_codec_reads_flax_bytes_and_flax_reads_the_codec():
    theirs, ours = _trees()
    _assert_same(msgpack_lite.unpackb(serialization.msgpack_serialize(theirs)),
                 ours)
    back = serialization.msgpack_restore(msgpack_lite.packb(ours))
    _assert_same(back, theirs)


@pytest.mark.parametrize("bad,match", [
    ({"t": (1, 2)}, "tuple"), ({"c": 1 + 2j}, "complex"),
    ({1: 2}, "not a str"), ({"o": np.array([None], object)}, "object"),
    ({"s": {1, 2}}, "set"),
])
def test_codec_refuses_what_it_cannot_write(bad, match):
    with pytest.raises(TypeError, match=match):
        msgpack_lite.packb(bad)


def test_codec_refuses_what_it_cannot_read():
    ext2 = serialization.msgpack_serialize({"c": 1 + 2j})
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack_lite.unpackb(ext2)
    chunked = msgpack_lite.packb({"w": {"__msgpack_chunked_array__": True}})
    with pytest.raises(ValueError, match="chunked"):
        msgpack_lite.unpackb(chunked)
    with pytest.raises(ValueError, match="truncated"):
        msgpack_lite.unpackb(msgpack_lite.packb({"a": "text"})[:-1])


# ------------------------------------------------------ template-free paths

def _jax_model(kind):
    if kind == "segpp":
        return jsegpp.YOLOSegPP(spec=jspec("yolov12", "n", 1, 4, "segment"))
    return jbuild_yolo("yolov12", "n", nc=1, ch=4, task=kind)


def _port_model(kind):
    if kind == "segpp":
        return build_segpp("yolov12", "n", 1, 4, "segment", device="cpu")
    return build_yolo("yolov12", "n", 1, 4, kind, device="cpu")


def _leaves(variables):
    return {(c,) + p: a for c in variables
            for p, a in _flatten(dict(variables[c])).items()}


@pytest.fixture(scope="module")
def drawn():
    """Random JAX variables per kind (numpy draws over eval_shape); the
    segment model's are YOLO-Seg++'s `yolo` subtree, whose spec it is."""
    segpp = draw_variables(_jax_model("segpp"))
    return {"detect": draw_variables(_jax_model("detect")), "segpp": segpp,
            "segment": {c: dict(segpp[c]["yolo"]) for c in segpp}}


@pytest.mark.parametrize("kind", ["detect", "segment", "segpp"])
def test_jax_variables_have_the_init_paths_and_cross_bit_exactly(kind,
                                                                  drawn):
    v = drawn[kind]
    tmod = _port_model(kind)
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    want, got = _leaves(v), _leaves(jax_variables(tmod))
    assert {k: np.shape(a) for k, a in got.items()} == {
        k: np.shape(a) for k, a in want.items()}
    for k, a in want.items():
        assert got[k].dtype == np.float32
        assert np.array_equal(got[k], np.asarray(a)), k


def test_inflate_stem_matches_jax():
    """Seeded 3-channel yolov12n-seg weights carried to the JAX layout
    (OIHW -> HWIO), inflated on both sides, carried back: equal exactly;
    the result loads into a 4-channel model; 4 channels pass unchanged,
    other counts raise."""
    three = build_yolo("yolov12", "n", 1, 3, "segment", device="cpu", seed=3)
    sd3 = three.state_dict()
    ours = inflate_stem_to_4ch(sd3)
    v = jax_variables(three)
    theirs = state_dict_from_jax(
        {"params": jax.device_get(jinflate(v["params"])),
         "batch_stats": v["batch_stats"]})
    assert ours["model.0.conv.weight"].shape == (16, 4, 3, 3)
    for k, t in theirs.items():
        assert torch.equal(ours[k], t), k
    build_yolo("yolov12", "n", 1, 4, "segment", device="cpu").load_state_dict(
        ours, strict=True)
    assert inflate_stem_to_4ch(ours) is ours
    bad = dict(sd3, **{"model.0.conv.weight": torch.zeros(16, 2, 3, 3)})
    with pytest.raises(ValueError, match="3-channel"):
        inflate_stem_to_4ch(bad)


# ------------------------------------------------------------- model files

@pytest.fixture(scope="module", params=["yolo", "segpp"])
def crossing(request, drawn):
    """(kind, JAX module, variables, jitted apply -> outputs to compare,
    port forward -> the same outputs, input)."""
    kind = request.param
    jkind = "segment" if kind == "yolo" else "segpp"
    jmod, v = _jax_model(jkind), drawn[jkind]
    x = np.random.default_rng(2).random((2, SIZE, SIZE, 4), np.float32)

    def pick(out):
        if kind == "segpp":
            mask, out = out
            return [mask] + list(out.raw)
        return list(out.raw) + [out.protos]

    apply = jax.jit(lambda v, x: pick(jmod.apply(v, x, train=False)))

    def forward(tmod):
        with torch.no_grad():
            out = pick(tmod(torch.from_numpy(x).permute(0, 3, 1, 2)))
        return [t.permute(0, 2, 3, 1).numpy() for t in out]

    return kind, v, apply, forward, x


def _close(got, want):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_port_model_file_is_read_by_jax(crossing, tmp_path):
    kind, v, apply, forward, x = crossing
    tmod = _port_model("segment" if kind == "yolo" else "segpp")
    tmod.load_state_dict(state_dict_from_jax(v), strict=True)
    path = str(tmp_path / "m.ckpt")
    model_io.save_model(path, tmod)
    jmod, jv = jmodel_io.load_model(path)
    assert type(jmod).__name__ == ("YOLOSegPP" if kind == "segpp"
                                   else "YOLOModel")
    assert jmod.spec == jspec("yolov12", "n", 1, 4, "segment")
    _close(forward(tmod), apply(jv, x))


def test_jax_model_file_is_read_by_the_port(crossing, tmp_path):
    kind, v, apply, forward, x = crossing
    path = str(tmp_path / "m.ckpt")
    jmodel_io.save_model(path, v, nc=1, ch=4, task="segment", kind=kind,
                         use_logits=True)
    tmod = model_io.load_model(path, device="cpu")
    assert not tmod.training
    _close(forward(tmod), apply(v, x))
