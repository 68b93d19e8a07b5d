"""PyTorch port: the detector's training-state `.ckpt` files against the JAX
trainer's, SGD in the tree form (`flat_opt=False`), f32 on the CPU,
yolov12n-seg (4 ch, nc=1) at 64^2 and batch 2.

One module-scoped JAX trainer compiles its step once and takes three steps
from a converted init and a fourth from the third's state; the port takes
the same steps from the same init. Both directions are held:

- port -> JAX: the port's `last.ckpt` restores into the JAX trainer's state
  with the same keys, shapes and dtypes, its counters equal and its float
  leaves within the trajectory's 1e-4 absolute of the JAX state after the
  same steps (`test_torch_port_trainer.py`'s tolerance). The momentum
  trace, which that test does not see, is a sum of clipped gradients of
  order 1 (its largest element 0.62 here): every element within 1e-3 and
  all but 0.1 % within 1e-4 (measured: 3.0e-4 at most, 163 of 2.8 M past
  1e-4); a parameter moves by lr times the trace, 2e-3 of it here, so
  that noise moves no parameter past 1e-6. The JAX
  step from the port's state agrees with the port's own fourth step, and the
  JAX package's default flat-vector trainer takes the port's file through
  its `load_resume` conversion;
- JAX -> port: the port restores a JAX file with every tensor equal bit for
  bit to the JAX leaf after the layout rules, writes it back byte for byte
  (the `hyperparams` scalars within 1 ulp of f32), and its next step agrees
  with the JAX step within the same tolerances.

The layouts of every optimizer configuration are held byte for byte
against the JAX states at init, the flat order against `ravel_pytree`, and
a resumed `train()` against an unbroken one. The flat-form and AdamW files
have files of their own (one JAX step compile each).
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from jax.flatten_util import ravel_pytree

from yolou_tpu.data.augment import AugHyp as JaxAugHyp
from yolou_tpu.engine import trainer_detector as jtd
from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.utils import checkpoint as jckpt
from yolou_tpu_torch.data.augment import AugHyp
from yolou_tpu_torch.data.config import load_data_yaml
from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                     DetectorTrainer)
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.tools.convert import state_dict_from_jax
from yolou_tpu_torch.utils import train_state
from yolou_tpu_torch.utils.msgpack_lite import packb, unpackb

from .test_torch_port_slice import jax_variables
from .test_torch_port_trainer import IMGSZ, OFF, _raw_batch, root  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401

KW = dict(imgsz=IMGSZ, batch_size=2, epochs=3, close_mosaic=0,
          max_instances=4, warmup_epochs=1.0, lr0=0.002, warmup_bias_lr=0.02)
SPE = 2
ATOL = 1e-4
MOMENT_ATOL, MOMENT_SHARE = 1e-3, 1e-3


class _Data:
    channels = 4


# ------------------------------------------------------------------ helpers

@pytest.fixture(scope="module")
def variables():
    jmod = build_yolo_jax("yolov12", "n", nc=1, ch=4, task="segment")
    return jmod, jax_variables(jmod, seed=3)


def jax_trainer(variables, **cfg):
    jmod, v = variables
    jcfg = jtd.DetectorTrainConfig(device_data=False, packed_upload=False,
                                   **dict(KW, **cfg))
    jtr = jtd.DetectorTrainer(jmod, v, _Data(), jcfg, aug=JaxAugHyp(**OFF))
    jtr.ensure_ready(steps_per_epoch=SPE)
    return jtr


def port_trainer(variables, **cfg):
    _, v = variables
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    model.load_state_dict(state_dict_from_jax(v), strict=True)
    tr = DetectorTrainer(model, _Data(), DetectorTrainConfig(**dict(KW, **cfg)),
                         aug=AugHyp(**OFF), device="cpu")
    tr.ensure_ready(steps_per_epoch=SPE)
    return tr


def jax_step(jtr, state, i):
    """The JAX trainer's step from host `state` on batch `i`."""
    batch = tuple(jnp.asarray(a) for a in _raw_batch(10 + i))
    state, loss, _ = jtr._step[False](state, batch, jax.random.key(i))
    return jax.device_get(state), float(loss)


def port_step(tr, i):
    gen = torch.Generator().manual_seed(i)
    loss, _ = tr.step(_raw_batch(10 + i), gen, use_mosaic=False)
    return loss.item()


def jax_runs(variables, **cfg):
    """A JAX trainer, its init (host, as the trainer holds it), the states
    after three steps and after a fourth from there (as dicts):
    (trainer, init, state3, state4, losses[4])."""
    jtr = jax_trainer(variables, **cfg)
    init = jax.device_get(jtr.state._asdict())
    state, losses = jtd.DetTrainState(**init), []
    for i in range(3):
        state, loss = jax_step(jtr, state, i)
        losses.append(loss)
    state4, loss = jax_step(jtr, state, 3)
    dicts = map(serialization.to_state_dict, (state, state4))
    return (jtr, init, *dicts, losses + [loss])


def port_runs(variables, path, **cfg):
    """The port from the same init: three steps, `last.ckpt` written at
    `path`, then the fourth step. (trainer, state3 tree, losses[4])."""
    tr = port_trainer(variables, **cfg)
    losses = [port_step(tr, i) for i in range(3)]
    tr.save_checkpoint(path)
    state3 = train_state.detector_state_tree(tr)
    losses.append(port_step(tr, 3))
    return tr, state3, losses


def tree_close(got, want, atol, what=""):
    """Same keys, shapes and dtypes; integer and bool leaves equal, float
    leaves within `atol`; optimizer moments (a sum of gradients) within
    MOMENT_ATOL, and all but MOMENT_SHARE of their elements within
    `atol`."""
    train_state._check_like(got, want)
    far = []
    for path, w in train_state._leaves(want):
        g, w = np.asarray(train_state._get(got, path)), np.asarray(w)
        where = f"{what} {'/'.join(path)}"
        if not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=where)
        elif {"trace", "mu", "nu"} & set(path):
            d = np.abs(g - w)
            assert d.max() <= MOMENT_ATOL, (where, d.max())
            far.append(((d > atol).sum(), d.size))
        else:
            np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=where)
    n_far, n = np.sum(far, axis=0) if far else (0, 1)
    assert n_far <= MOMENT_SHARE * n, (what, n_far, n)


def tree_bits(got, want, what=""):
    """Same keys, shapes and dtypes and every leaf equal bit for bit, but
    the `hyperparams` scalars, within 1 ulp of f32."""
    train_state._check_like(got, want)
    for path, w in train_state._leaves(want):
        g, w = np.asarray(train_state._get(got, path)), np.asarray(w)
        where = f"{what} {'/'.join(path)}"
        if "hyperparams" in path:
            assert abs(int(g.view(np.int32)) - int(w.view(np.int32))) <= 1, (
                where, g, w)
        else:
            assert g.tobytes() == w.tobytes(), where


def jax_restores(path, target):
    """The JAX package's own restore of a file into its trainer's state."""
    return serialization.to_state_dict(jckpt.load_checkpoint(path, target))


# ------------------------------------------------------------ layouts, codec

CONFIGS = {
    "sgd": {},
    "sgd-no-clip": {"clip_grad_norm": 0.0},
    "sgd-no-skip": {"skip_nonfinite": False},
    "sgd-no-decay": {"weight_decay": 0.0},
    "adamw": {"optimizer": "adamw"},
    "adamw-no-clip-no-skip": {"optimizer": "adamw", "clip_grad_norm": 0.0,
                              "skip_nonfinite": False},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_state_is_the_jax_state_byte_for_byte(variables, name):
    """At init the port's tree form, written by the port's codec, is the
    JAX trainer's state as `flax.serialization.msgpack_serialize` writes
    it: the optax layout of every configuration ({} leaves, the decay
    group's extra level, the clip and the finite gate where set), the
    counters' 0-d int32 and bool leaves, the hyperparams at count 0."""
    cfg = dict(CONFIGS[name], flat_opt=False)
    jtr = jax_trainer(variables, **cfg)
    want = serialization.msgpack_serialize(serialization.to_state_dict(
        jax.device_get(jtr.state._asdict())))
    cfg.pop("flat_opt")
    got = packb(train_state.detector_state_tree(port_trainer(variables,
                                                             **cfg)))
    assert got == want


def test_codec_writes_counters_and_masked_nodes_as_flax():
    """{} (a MaskedNode), 0-d int32 and bool arrays (ext 1, as a fetched
    device scalar is written) and numpy scalars (ext 3), both ways."""
    tree = {"empty": {}, "i": np.asarray(7, np.int32),
            "b": np.asarray(False), "f": np.asarray(0.25, np.float32),
            "si": np.int32(-3), "sb": np.bool_(True),
            "dev": jax.device_get(jnp.zeros((), jnp.int32))}
    want = serialization.msgpack_serialize(tree)
    assert packb(tree) == want
    assert want[want.index(b"empty") + 5] == 0x80       # an empty fixmap
    back = unpackb(want)
    for k in ("i", "b", "f", "dev"):
        assert type(back[k]) is np.ndarray and back[k].shape == (), k
    assert isinstance(back["si"], np.int32) and isinstance(back["sb"],
                                                           np.bool_)
    assert back["empty"] == {} and packb(back) == want


def test_flat_order_is_ravel_pytree(variables):
    _, v = variables
    params = v["params"]
    want, unravel_jax = ravel_pytree(params)
    got = train_state.ravel(params)
    assert got.dtype == np.float32 and np.array_equal(got, np.asarray(want))
    paths = [tuple(k.key for k in p) for p, _ in
             jax.tree_util.tree_leaves_with_path(params)]
    assert [p for p, _ in train_state._leaves(params)] == paths
    order = [p[0] for p in paths]
    assert order.index("model_11") < order.index("model_2")
    vec = np.arange(got.size, dtype=np.float32)
    back = train_state.unravel(vec, params)
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_leaves_with_path(unravel_jax(vec)),
            jax.tree_util.tree_leaves_with_path(back)):
        assert np.array_equal(np.asarray(a), b), path
    with pytest.raises(ValueError, match="flat vector of 3 values"):
        train_state.unravel(vec[:3], params)


def test_groups_are_the_port_parameter_groups(variables):
    """`group_of` (the JAX labels by leaf name) puts each parameter where
    the port's `parameter_groups` does."""
    from yolou_tpu_torch.engine.trainer_detector import parameter_groups
    tr = port_trainer(variables)
    names = {id(p): n for n, p in tr.model.named_parameters()}
    want = {names[id(p)]: g for g, ps in parameter_groups(tr.model).items()
            for p in ps}
    got = {}
    tree = train_state.detector_state_tree(tr)["params"]
    for path, _ in train_state._leaves(tree):
        one = {}
        train_state._put(one, path, np.zeros(1, np.float32))
        got.update({n: train_state.group_of(path)
                    for n in state_dict_from_jax({"params": one})
                    if ".dfl." not in n})
    assert got == want


# ------------------------------------------------------------ both directions

def make_runs(variables, d, **cfg):
    """The JAX trainer's three steps and fourth, its `last.ckpt` of step 3
    (written by the JAX package), and the port's same steps with its own
    `last.ckpt` of step 3."""
    jtr, init, state3, state4, losses = jax_runs(variables, flat_opt=False,
                                                 **cfg)
    jpath = str(d / "jax_last.ckpt")
    jckpt.save_checkpoint(jpath, state3)
    ppath = str(d / "port_last.ckpt")
    tr, pstate3, plosses = port_runs(variables, ppath, **cfg)
    return dict(jtr=jtr, init=init, state3=state3, state4=state4,
                losses=losses, jpath=jpath, ppath=ppath, port=tr,
                pstate3=pstate3, plosses=plosses, dir=d, cfg=cfg)


def _counts(tree):
    """{path: value} of every int32 leaf of a state (step, counts)."""
    return {"/".join(p): int(v) for p, v in train_state._leaves(tree)
            if np.asarray(v).dtype == np.int32}


def check_port_file_in_jax(runs):
    """port -> JAX: the JAX package restores the port's file into its
    trainer's state, near the JAX state after the same steps."""
    np.testing.assert_allclose(runs["plosses"], runs["losses"], rtol=1e-4)
    got = jax_restores(runs["ppath"], runs["init"])
    counts = _counts(got)
    for k in ("notfinite_count", "total_notfinite"):
        assert counts.pop(f"opt_state/{k}") == 0
    assert counts["step"] == 3 and set(counts.values()) == {3}, counts
    tree_close(got, runs["state3"], ATOL, "port->jax")
    # the moments moved off zero: carried, not reinitialized
    moments = [np.abs(v).max() for p, v in train_state._leaves(got)
               if {"trace", "mu"} & set(p)]
    assert len(moments) > 100 and max(moments) > 1e-2


def check_jax_steps_from_port_file(runs):
    state = jtd.DetTrainState(**jckpt.load_checkpoint(runs["ppath"],
                                                      runs["init"]))
    state4, loss = jax_step(runs["jtr"], state, 3)
    np.testing.assert_allclose(loss, runs["plosses"][3], rtol=1e-4)
    tree_close(train_state.detector_state_tree(runs["port"]),
               serialization.to_state_dict(state4), ATOL,
               "port step 4 vs jax from port file")


def check_port_restores_jax_file(runs, variables):
    """JAX -> port, bit for bit: the port's tree of the restored state is
    the JAX file's, and the torch tensors are its leaves after the layout
    rules."""
    tr = port_trainer(variables, **runs["cfg"])
    tr.load_resume(runs["jpath"])
    assert (tr.step_count, tr.opt_count, tr.notfinite_count()) == (3, 3, 0)
    assert tr.last_finite and tr.total_notfinite == 0
    tree_bits(train_state.detector_state_tree(tr), runs["state3"],
              "jax->port")
    sd = state_dict_from_jax({"params": runs["state3"]["ema_params"]})
    names = [n for n, p in tr.model.named_parameters() if p.requires_grad]
    for n, e in zip(names, tr.ema_params):
        assert torch.equal(e, sd[n]), n
    return tr


def check_port_next_step(runs, variables):
    tr = port_trainer(variables, **runs["cfg"])
    tr.load_resume(runs["jpath"])
    loss = port_step(tr, 3)
    np.testing.assert_allclose(loss, runs["losses"][3], rtol=1e-4)
    tree_close(train_state.detector_state_tree(tr), runs["state4"], ATOL,
               "port from jax file, step 4")


def _hyperparams_of(ours, theirs):
    """`ours` with every `hyperparams` map taken from `theirs`."""
    return {k: theirs[k] if k == "hyperparams" else
            _hyperparams_of(v, theirs[k]) if isinstance(v, dict) else v
            for k, v in ours.items()}


def check_round_trip(runs, variables):
    """The JAX file, restored by the port and written again: the same bytes
    but for the injected hyperparams scalars (within 1 ulp)."""
    tr = port_trainer(variables, **runs["cfg"])
    tr.load_resume(runs["jpath"])
    out = str(runs["dir"] / "again.ckpt")
    tr.save_checkpoint(out)
    with open(runs["jpath"], "rb") as f:
        jax_bytes = f.read()
    with open(out, "rb") as f:
        port_bytes = f.read()
    assert len(port_bytes) == len(jax_bytes)
    ours, theirs = unpackb(port_bytes), unpackb(jax_bytes)
    tree_bits(ours, theirs)
    assert packb(_hyperparams_of(ours, theirs)) == jax_bytes
    return port_bytes == jax_bytes


@pytest.fixture(scope="module")
def runs(variables, tmp_path_factory):
    return make_runs(variables, tmp_path_factory.mktemp("sgd_state"))


def test_port_file_restores_in_jax_near_its_state(runs):
    check_port_file_in_jax(runs)
    got = jax_restores(runs["ppath"], runs["init"])
    inner = got["opt_state"]["inner_state"]["1"]["inner_states"]
    trace = inner["decay"]["inner_state"]["1"]["inner_state"]["0"]["trace"]
    assert np.abs(trace["model_0"]["conv"]["kernel"]).max() > 1e-3


def test_jax_steps_on_from_the_port_file(runs):
    check_jax_steps_from_port_file(runs)


def test_jax_default_flat_trainer_converts_the_port_file(runs, variables,
                                                         capsys):
    jtr = jax_trainer(variables)            # flat_opt=True, the default
    assert jtr._flat is not None
    jtr.load_resume(runs["ppath"])
    assert "converted tree-form checkpoint" in capsys.readouterr().out
    st = jax.device_get(jtr.state)
    assert int(st.step) == 3 and int(st.opt_state.count) == 3
    want = runs["pstate3"]
    assert np.array_equal(np.asarray(st.ema_params),
                          train_state.ravel(want["ema_params"]))
    tree_bits({"params": st.params, "batch_stats": st.batch_stats},
              {"params": want["params"], "batch_stats": want["batch_stats"]})


def test_port_restores_the_jax_file_bit_for_bit(runs, variables):
    tr = check_port_restores_jax_file(runs, variables)
    assert all("momentum_buffer" in tr.optimizer.state[p] for p in tr.params)


def test_port_next_step_from_the_jax_file_agrees(runs, variables):
    check_port_next_step(runs, variables)


def test_jax_file_round_trips_through_the_port_byte_for_byte(runs,
                                                             variables):
    check_round_trip(runs, variables)


# ------------------------------------------------------------ refusals

def test_mismatched_files_raise_by_name(runs, variables, tmp_path):
    adamw = port_trainer(variables, optimizer="adamw")
    with pytest.raises(ValueError, match="an sgd training state.*adamw"):
        adamw.load_resume(runs["jpath"])
    tree = unpackb(open(runs["jpath"], "rb").read())
    tree["ema_params"] = train_state.ravel(tree["ema_params"])
    with pytest.raises(ValueError, match="flat-form SGD.*adamw"):
        train_state.restore_detector_state(adamw, tree)

    tr = port_trainer(variables)
    bad = unpackb(open(runs["jpath"], "rb").read())
    leaf = bad["params"]["model_0"]["conv"]["kernel"]
    bad["params"]["model_0"]["conv"]["kernel"] = torch.from_numpy(
        leaf.copy()).to(torch.bfloat16)
    with pytest.raises(ValueError, match="params/model_0/conv/kernel: "
                                         "torch.bfloat16"):
        train_state.restore_detector_state(tr, bad)
    bad["params"]["model_0"]["conv"]["kernel"] = leaf[..., :2]
    with pytest.raises(ValueError, match="model_0/conv/kernel: float32"):
        train_state.restore_detector_state(tr, bad)
    bad["params"]["model_0"]["conv"]["kernel"] = leaf
    bad["opt_state"]["inner_state"]["1"]["inner_states"]["bias"][
        "inner_state"]["inner_state"]["0"]["trace"]["model_0"]["conv"][
        "kernel"] = leaf
    with pytest.raises(ValueError, match="bias/inner_state/inner_state/0/"
                                         "trace/model_0/conv/kernel"):
        train_state.restore_detector_state(tr, bad)
    fresh = DetectorTrainer(build_yolo("yolov12", "n", nc=1, ch=4,
                                       device="cpu"), _Data(),
                            DetectorTrainConfig(**KW), device="cpu")
    with pytest.raises(RuntimeError, match="ensure_ready"):
        fresh.load_resume(runs["jpath"])


# ------------------------------------------------------------ train() resume

def test_resumed_train_matches_an_unbroken_run(root, tmp_path):  # noqa: F811
    """A 3-epoch `train()` whose `last.ckpt` of epoch 2 is kept, then
    `train(resume_from=...)` of that file in a fresh trainer of the same
    configuration: it starts at epoch `step_count // steps_per_epoch` = 2,
    and its history and final state (weights, EMA, statistics, momentum,
    counters) are the unbroken run's.
    Augmentation is off: both packages seed the augmentation anew on
    resume, so the two runs draw the same numbers only without it."""
    data_cfg = load_data_yaml(os.path.join(root, "data.yaml"))

    def trainer(run, epochs):
        model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                           device="cpu", seed=1)
        cfg = DetectorTrainConfig(imgsz=IMGSZ, batch_size=4, epochs=epochs,
                                  close_mosaic=0, max_instances=8,
                                  warmup_epochs=1.0,
                                  run_dir=str(tmp_path / run))
        return DetectorTrainer(model, data_cfg, cfg, aug=AugHyp(**OFF),
                               device="cpu")

    whole = trainer("whole", 3)
    save = whole.save_checkpoint

    def keep_epoch_two(path):     # the file an interrupted run left behind
        save(path)
        if whole.step_count == 4:
            shutil.copy(path, tmp_path / "epoch2.ckpt")
    whole.save_checkpoint = keep_epoch_two
    h = whole.train()
    run = tmp_path / "whole" / os.listdir(tmp_path / "whole")[0]
    assert sorted(os.listdir(run / "weights")) == ["last.ckpt"]
    rest = trainer("rest", 3)
    h2 = rest.train(resume_from=str(tmp_path / "epoch2.ckpt"))
    assert rest.step_count == whole.step_count == 6      # ceil(6 / 4) = 2
    assert len(h2["loss"]) == 1
    for k in h2:
        np.testing.assert_allclose(h2[k], h[k][2:], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    tree_close(train_state.detector_state_tree(rest),
               train_state.detector_state_tree(whole), ATOL, "resumed")
