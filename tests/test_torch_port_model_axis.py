"""PyTorch port: the model axis (`parallel/mesh.py`'s data x model mesh,
`param_sharding_rules`, `shard_module`, the cut convs of `nn/blocks.py`)
on gloo ranks on the CPU, f32, against one process over the same global
batch.

- The rules cut exactly the leaves the JAX package's
  `param_sharding_rules` cuts, at min_size 2^12 and 2^16 on JAX meshes of
  2 x 2 and 2 x 4 of the conftest's virtual devices (shapes only, no
  compile): a tree of ones where JAX cuts and zeros elsewhere goes
  through `state_dict_from_jax`, which maps the names and the qkv
  permutation.
- One `launch` of four ranks as a 2 x 2 mesh runs the jobs of
  `torch_parallel_ranks.py`: three detector steps (mosaic, mixup and cutmix
  on, global batch 4, `min_size=2**12`: 99 weights cut) with the
  training-state file written before the first step and after the last and
  one more step after that; a resume of the one-process file and the same
  step; the decoder update and validation; the Evaluator with a padded last
  batch; a depthwise conv whose input the cut slices. Two ranks as a 1 x 2
  mesh take the same three steps.
- Tolerances are the data-parallel tests' (`test_torch_port_parallel.py`):
  loss and parts rtol 3e-4; parameters, EMA and BatchNorm statistics rtol
  1e-3 / atol 5e-5; the gradient norm 1e-4 against one process's (the
  first step's gradient norm is ~2e3 and the cut convs run another
  channel count, so on the CPU it parts from one process's by ~2e-5 on a
  1 x 2 mesh already; on the H100 with TF32 off by 1.6e-7, where
  `chip_smoke.py` holds it to 1e-5); the decoder's parameters 3e-5
  absolute, its metrics and the Evaluator's 1e-6.
  The replicated parameters and statistics are bit-identical across each
  model group after the three steps, and the file written before any step
  is byte for byte one process's.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.parallel import mesh as jmesh
from yolou_tpu_torch.data.augment import AugHyp
from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                     DetectorTrainer)
from yolou_tpu_torch.losses import v8
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.nn.attention import A2C2f, AAttn
from yolou_tpu_torch.nn.blocks import Conv
from yolou_tpu_torch.parallel import mesh as meshlib
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from . import torch_parallel_ranks as ranks
from .test_torch_port_parallel import (_det_batch, _seg_data, _segpp_state,
                                       _val_batches)
from .test_torch_port_trainer import OFF
from .torch_threads import one_torch_thread  # noqa: F401

S = 64
LAUNCH_TIMEOUT = 240
CUT_2_12 = 99           # weights cut at n_model 2
CUT_2_16 = 9


def _yolo(seed=None):
    return build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                      device="cpu", seed=seed)


def _fake_mesh(n_model, n_data=1, rank=0):
    """A mesh object for code that runs no collective."""
    return meshlib.Mesh(rank=rank, size=n_data * n_model,
                        device=torch.device("cpu"), backend="gloo",
                        n_model=n_model)


# ------------------------------------------------------------------ rules

@functools.lru_cache(1)
def _jax_params():
    jdet = build_yolo_jax("yolov12", "n", nc=1, ch=4, task="segment")
    return jax.eval_shape(lambda: jdet.init(
        jax.random.key(0), jnp.zeros((1, S, S, 4)), train=False))["params"]


def _jax_cut_names(n_model, min_size):
    params = _jax_params()
    mesh = jmesh.make_mesh(n_data=2, n_model=n_model)
    rules = jmesh.param_sharding_rules(mesh, params, min_size=min_size)
    marks = jax.tree_util.tree_map(
        lambda x, r: np.full(x.shape, float("model" in tuple(r.spec)),
                             np.float32), params, rules)
    sd = state_dict_from_jax({"params": marks})
    return {n for n, t in sd.items() if t.numel() and bool((t == 1).all())}


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("min_size", [2 ** 12, 2 ** 16])
def test_rules_cut_the_jax_leaves(n_model, min_size):
    model = _yolo()
    mesh = _fake_mesh(n_model)
    rules = meshlib.param_sharding_rules(mesh, model, min_size=min_size)
    got = {n for n, s in rules.items() if s.axis == "model"}
    assert got == _jax_cut_names(n_model, min_size)
    # a name -> tensor mapping cuts the same (the one transposed conv,
    # model.22.proto.upsample, is square)
    flat = meshlib.param_sharding_rules(mesh, dict(model.named_parameters()),
                                        min_size=min_size)
    assert {n for n, s in flat.items() if s.axis == "model"} == got
    params = dict(model.named_parameters())
    for n in got:
        assert rules[n] == meshlib.Sharding("model", 0, n_model,
                                            1 if "upsample" in n else 0)
    if n_model == 2:
        want = {2 ** 12: (CUT_2_12, 2_747_392), 2 ** 16: (CUT_2_16, 1_179_648)}
        assert (len(got), sum(params[n].numel() for n in got)) == \
            want[min_size]
        assert sum(p.numel() for p in params.values()) == 2_821_155
    assert not any(s.axis for s in meshlib.param_sharding_rules(
        _fake_mesh(1, 4), model, min_size=1).values())


def test_shard_module_keeps_the_slices():
    """Rank 1 of 1 x 2 keeps the second half of each cut weight's output
    channels; `whole_copy` has whole shapes and no cut; `local_part`."""
    model, whole = _yolo(seed=1), _yolo(seed=1)
    mesh = _fake_mesh(2, rank=1)
    rules = meshlib.param_sharding_rules(mesh, model, min_size=2 ** 12)
    meshlib.shard_module(mesh, model, rules)
    cut = meshlib.model_shards(model)
    assert len(cut) == CUT_2_12
    full = dict(whole.named_parameters())
    for name, p in model.named_parameters():
        w = full[name]
        if name in cut:
            dim = cut[name].dim
            k = w.shape[dim] // 2
            assert torch.equal(p, w.narrow(dim, k, k)), name
            assert torch.equal(meshlib.local_part(model, name, w), p)
        else:
            assert torch.equal(p, w), name
    n_bytes = sum(p.numel() * 4 for p in model.parameters())
    assert n_bytes == 4 * (2_821_155 - 2_747_392 // 2)
    copy = meshlib.whole_copy(model)
    assert not meshlib.model_shards(copy)
    assert {n: p.shape for n, p in copy.named_parameters()} == \
        {n: p.shape for n, p in whole.named_parameters()}
    with pytest.raises(ValueError, match="once"):
        meshlib.shard_module(mesh, model, rules)


def test_a_cut_weight_is_never_folded():
    """Conv.folded, AAttn's eval qkv fold and A2C2f's fold cache raise by
    name on a slice; a cut conv outside its mesh raises."""
    model = _yolo(seed=2).eval()
    mesh = _fake_mesh(2)
    meshlib.shard_module(mesh, model, meshlib.param_sharding_rules(
        mesh, model, min_size=2 ** 12))
    conv = next(m for m in model.modules() if isinstance(m, Conv)
                and hasattr(m.conv, "model_shard"))
    with pytest.raises(RuntimeError, match="model axis"):
        conv.folded()
    attn = next(m for m in model.modules() if isinstance(m, AAttn)
                and hasattr(m.qkv.conv, "model_shard"))
    with pytest.raises(RuntimeError, match="model axis"):
        attn.folded_qkv(torch.float32)
    a2 = next(m for m in model.modules() if isinstance(m, A2C2f)
              and any(hasattr(c, "model_shard") for c in m.modules()))
    with pytest.raises(RuntimeError, match="model axis"):
        a2.folded_weights(torch.float32)
    with pytest.raises(RuntimeError, match="with mesh"):
        conv(torch.zeros(1, conv.conv.in_channels, 8, 8))


def test_v8_loss_counts_batch_shards_not_ranks():
    """Under a 1 x 2 mesh (one batch shard, two ranks) the loss is one
    process's: the global batch is b times the data axis, and no
    normalizer is reduced."""
    model = _yolo(seed=3).train()
    tr = DetectorTrainer(model, None, DetectorTrainConfig(
        imgsz=S, batch_size=4, max_instances=4), aug=AugHyp(**OFF),
        device="cpu")
    aug = tr.augment(_det_batch(4), torch.Generator().manual_seed(0), False)
    with torch.no_grad():
        out = model(aug["img"].permute(0, 3, 1, 2))
        want = tr.loss(out, aug)
        with _fake_mesh(2):
            assert meshlib.data_size() == 1 and meshlib.world_size() == 2
            got = tr.loss(out, aug)
    assert torch.equal(got.total, want.total)
    assert v8.data_size is meshlib.data_size


# ------------------------------------------------------- ranks vs process

def _steps_spec(state_dict, tmp):
    return {"state_dict": state_dict,
            "cfg": dict(imgsz=S, batch_size=4, epochs=1, close_mosaic=0,
                        max_instances=4, warmup_epochs=1.0),
            "aug": dict(mixup=0.5, cutmix=0.5), "steps_per_epoch": 2,
            "seed": 0, "use_mosaic": True, "min_size": 2 ** 12,
            "device": "cpu", "ckpt_dir": str(tmp),
            "batches": [_det_batch(10), _det_batch(11), _det_batch(12)],
            "twin": (_det_batch(13), 5)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("model_axis")
    sd = ranks.numpy_state(_yolo(seed=3).state_dict())
    steps = _steps_spec(sd, tmp)
    one = ranks.trajectory(steps)
    resumed = dict(steps, batches=[], ckpt_dir=None,
                   resume=str(tmp / "one_last.ckpt"))
    rng = np.random.default_rng(4)
    c = 128
    dw = {"c": c, "x": rng.normal(size=(4, c, 6, 6)).astype(np.float32),
          "g": rng.normal(size=(4, c, 6, 6)).astype(np.float32),
          "weight": rng.normal(0, 0.1, (c, 1, 7, 7)).astype(np.float32)}
    seg = _segpp_state(5)
    img, mask, om = _seg_data(7, 8)
    dec = {"state_dict": seg, "cfg": dict(image_size=S, batch_size=8),
           "batch": (img, mask, om), "val_batches": _val_batches(8, 14, 8)}
    ev = {"state_dict": seg, "size": S, "batch_size": 8, "hd95": True,
          "batches": [(b[0], b[1], None, b[3])
                      for b in _val_batches(9, 10, 8)]}
    jobs = [("layout", None),
            ("trajectory", dict(steps, tag="2x2")),
            ("trajectory:resumed", resumed),
            ("depthwise", dw), ("decoder_update", dec), ("evaluate", ev)]
    out = {"one": one}
    # the 1 x 2 ranks run beside the 2 x 2 ones
    pair = threading.Thread(target=lambda: out.update({"1x2": meshlib.launch(
        ranks.in_mesh, 2, ["cpu"] * 2,
        [("trajectory", dict(steps, tag="1x2"))], 1, 2,
        timeout=LAUNCH_TIMEOUT)}))
    pair.start()
    try:
        out["2x2"] = meshlib.launch(ranks.in_mesh, 4, ["cpu"] * 4, jobs, 2,
                                    2, timeout=LAUNCH_TIMEOUT)
        out["process"] = {name: getattr(ranks, name)(spec)
                          for name, spec in jobs[3:]}
    finally:
        pair.join()
    assert "1x2" in out, "the 1 x 2 ranks failed (see the traceback)"
    out["tmp"], out["steps"] = tmp, steps
    return out


def test_the_mesh_is_jax_s_grid(runs):
    """Rank r sits at (r // 2, r % 2), as JAX's make_mesh(2, 2) places
    device r; data groups are the columns, model groups the rows."""
    grid = np.vectorize(lambda d: d.id)(
        jmesh.make_mesh(n_data=2, n_model=2).devices)
    assert runs["2x2"]["shape"] == {"data": 2, "model": 2}
    for rank, d, m, data_group, model_group in runs["2x2"]["layout"]:
        assert grid[d, m] == rank
        assert data_group == grid[:, m].tolist()
        assert model_group == grid[d].tolist()


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_detector_steps_equal_one_process(runs, mesh):
    got, want = runs[mesh]["trajectory"], runs["one"]
    assert got["counts"] == want["counts"] == (3, 3, 0)
    for (gl, gp), (wl, wp) in zip(got["losses"], want["losses"]):
        np.testing.assert_allclose(gl, wl, rtol=3e-4)
        for k in ("box", "cls", "dfl", "seg"):
            assert wp[k] > 0
            np.testing.assert_allclose(gp[k], wp[k], rtol=3e-4, err_msg=k)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)
    ranks.close(got["state_dict"], want["state_dict"], 1e-3, 5e-5, "params")
    ranks.close(got["ema"], want["ema"], 1e-3, 5e-5, "ema")


@pytest.mark.parametrize("mesh", ["2x2", "1x2"])
def test_each_rank_holds_its_slices(runs, mesh):
    """The replicated tensors are bit-identical across each model group
    after three steps; every rank cut 99 weights and holds the parameter
    bytes of the replicated ones and half the cut ones; kernel C's
    backward ran 8 times a step in every rank (its forward launches count
    on the card only)."""
    got = runs[mesh]["trajectory"]
    one = runs["one"]["ranks"][0]
    assert one["n_cut"] == 0 and one["param_bytes"] == 4 * 2_821_155
    assert len(got["ranks"]) == (4 if mesh == "2x2" else 2)
    for r in got["ranks"]:
        assert r["replicas_identical"]
        assert r["n_cut"] == CUT_2_12
        assert r["param_bytes"] == one["param_bytes"] - 4 * 2_747_392 // 2
        assert r["launches"] == one["launches"] == [(0, 8)] * 3


def test_files_hold_whole_tensors_and_resume_across_meshes(runs):
    """The 2 x 2 state file before any step is one process's byte for byte;
    its last.ckpt, read by one process, takes the next step as the 2 x 2
    mesh took it; and the mesh, resuming one process's file, the step one
    process took."""
    tmp = runs["tmp"]
    assert (tmp / "2x2_init.ckpt").read_bytes() == \
        (tmp / "one_init.ckpt").read_bytes()
    mesh, one = runs["2x2"]["trajectory"], runs["one"]
    assert (tmp / "2x2_last.ckpt").stat().st_size == \
        (tmp / "one_last.ckpt").stat().st_size
    from_mesh = ranks.trajectory(dict(
        runs["steps"], batches=[], ckpt_dir=None,
        resume=str(tmp / "2x2_last.ckpt")))
    resumed = runs["2x2"]["trajectory:resumed"]
    for got, want in ((from_mesh, mesh), (resumed, one)):
        np.testing.assert_allclose(got["twin"][0], want["twin"][0],
                                   rtol=3e-4)
        for k, w in want["twin_state"].items():
            if not k.endswith("num_batches_tracked"):   # in no state file
                ranks.close(got["twin_state"][k], w, 1e-3, 5e-5, k)


def test_depthwise_cut_takes_its_input_slice(runs):
    got, want = runs["2x2"]["depthwise"], runs["process"]["depthwise"]
    assert got["cut"] == (64, 1, 7, 7) and want["cut"] == (128, 1, 7, 7)
    for k in ("y", "x_grad", "weight_grad"):
        ranks.close(got[k], want[k], 1e-6, 1e-6, k)


def test_decoder_update_equals_one_process(runs):
    got, want = runs["2x2"]["decoder_update"], \
        runs["process"]["decoder_update"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["dice"], want["dice"], rtol=1e-5)
    for k, w in want["state_dict"].items():
        g = got["state_dict"][k]
        if k.startswith("yolo."):
            assert torch.equal(g, w), k
        else:
            ranks.close(g, w, 0, 3e-5, k)
    for k, w in want["val"].items():
        np.testing.assert_allclose(got["val"][k], w, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_evaluator_equals_one_process(runs):
    got, want = runs["2x2"]["evaluate"], runs["process"]["evaluate"]
    assert got["n_images"] == want["n_images"] == 10
    for k in ("dice", "hd95", "precision", "recall"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
