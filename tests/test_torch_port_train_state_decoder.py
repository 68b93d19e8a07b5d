"""PyTorch port: the decoder's training-state `.ckpt` files against the JAX
decoder trainer's, f32 on the CPU, YOLO-Seg++ over yolov12n (4 ch, nc=1)
at 64^2 and batch 2, without and with `clip_grad_norm`.

A module-scoped JAX trainer per configuration compiles its step once and
takes three updates from the init of `test_torch_port_decoder_trainer.py`
and a fourth from there; the port takes the same updates. Held:

- the layout: at init the port's file is the JAX state's bytes
  (`optax.masked(adamw)`, one level deeper with the clip, `{}` in `mu` and
  `nu` under `yolo`);
- port -> JAX: the port's `last.ckpt` restores into the JAX trainer's state
  with no key, shape or dtype mismatch; counters equal, the encoder bit for
  bit, and the decoder's parameters and statistics within that file's
  trajectory tolerance (every element within 5e-5, half an update at lr
  1e-4, all but 0.5 % within 1e-6; AdamW's per-element normalisation makes
  the trajectory noise-limited, as that file explains). Every element of
  `mu` (b1's mean of the gradients) within 1e-4 of the largest `mu` in the
  state, and of `nu` (the mean of their squares) within 1e-4 of the largest
  `nu`: the gradients that feed them differ by f32 noise (measured: 7.4e-6
  and 1.6e-6 of the largest; leaf by leaf the ratio is meaningless, as
  some BatchNorm biases have gradients of 1e-11, all noise);
- JAX -> port: every tensor bit for bit, the file written back byte for
  byte, the next update within the same tolerances;
- a resumed `train()` against an unbroken one, and an encoder that is not
  the file's refused by name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

from yolou_tpu.engine import trainer_decoder as jtd
from yolou_tpu.utils import checkpoint as jckpt
from yolou_tpu_torch.engine.trainer_decoder import cosine_decay
from yolou_tpu_torch.utils import train_state
from yolou_tpu_torch.utils.msgpack_lite import packb, unpackb

from .test_torch_port_decoder_trainer import (CFG, _port_trainer, root,
                                              variables)  # noqa: F401
from .test_torch_port_train_state import tree_bits
from .torch_threads import one_torch_thread  # noqa: F401

CLIP = 0.05          # below the decoder's gradient norm here: it clips


def _batches(n=4):
    rng = np.random.default_rng(7)
    for _ in range(n):
        yield (rng.integers(0, 255, (2, 64, 64, 4), dtype=np.uint8),
               ((rng.random((2, 64, 64, 1)) > 0.6) * 255).astype(np.uint8),
               rng.random((2, 8, 8, 1)).astype(np.float32))


def decoder_close(got, want, what=""):
    """Keys, shapes and dtypes equal; integers equal; the encoder bit for
    bit; the decoder's parameters and statistics, `mu` and `nu` within the
    module's tolerances."""
    train_state._check_like(got, want)
    far, moments = [], {"mu": [0.0, 0.0], "nu": [0.0, 0.0]}
    for path, w in train_state._leaves(want):
        g, w = np.asarray(train_state._get(got, path)), np.asarray(w)
        where = f"{what} {'/'.join(path)}"
        if not np.issubdtype(w.dtype, np.floating) or "yolo" in path:
            assert g.tobytes() == w.tobytes(), where
            continue
        d = np.abs(g - w)
        kind = {"mu", "nu"} & set(path)
        if kind:
            m = moments[kind.pop()]
            m[0], m[1] = max(m[0], d.max()), max(m[1], np.abs(w).max())
        else:
            assert d.max() <= 5e-5, (where, d.max())
            far.append(((d > 1e-6).sum(), d.size))
    n_far, n = np.sum(far, axis=0)
    assert n_far <= 5e-3 * n, (what, n_far, n)
    for kind, (d, top) in moments.items():
        assert 0 < top and d <= 1e-4 * top, (what, kind, d, top)


def _runs(variables, root, d, **cfg):  # noqa: F811
    jmod, v = variables
    jcfg = jtd.DecoderTrainConfig(device_data=False, run_dir=str(d),
                                  **dict(CFG, **cfg))
    jtr = jtd.DecoderTrainer(jmod, v, root, jcfg)
    jtr.ensure_ready(steps_per_epoch=2)
    init = jax.device_get(jtr.state._asdict())
    state, losses = jtd.TrainState(**init), []
    batches = list(_batches())
    for i, batch in enumerate(batches):
        if i == 3:
            state3 = state
        state, loss, _ = jtr._train_step(state, *map(jnp.asarray, batch))
        state = jax.device_get(state)
        losses.append(float(loss))
    jpath = str(d / "jax_last.ckpt")
    jckpt.save_checkpoint(jpath, state3)

    tr = _port_trainer(v, root, d / "port", **cfg)
    tr.ensure_ready(steps_per_epoch=2)
    plosses = []
    for i, batch in enumerate(batches):
        if i == 3:
            ppath = str(d / "port_last.ckpt")
            tr._save(ppath)
            pstate3 = train_state.decoder_state_tree(tr)
        plosses.append(tr.step(*batch)[0].item())
    to_dict = serialization.to_state_dict
    return dict(jtr=jtr, init=init, state3=to_dict(state3),
                state4=to_dict(state), losses=losses, jpath=jpath,
                port=tr, pstate3=pstate3, plosses=plosses, ppath=ppath,
                cfg=cfg, dir=d, v=v)


@pytest.fixture(scope="module", params=["no-clip", "clip"])
def runs(request, variables, root, tmp_path_factory):  # noqa: F811
    cfg = {"clip_grad_norm": CLIP} if request.param == "clip" else {}
    return _runs(variables, root, tmp_path_factory.mktemp("dec_state"),
                 **cfg)


def test_init_state_is_the_jax_state_byte_for_byte(runs, root):  # noqa: F811
    tr = _port_trainer(runs["v"], root, runs["dir"] / "init", **runs["cfg"])
    tr.ensure_ready(steps_per_epoch=2)
    want = serialization.msgpack_serialize(serialization.to_state_dict(
        runs["init"]))
    tree = train_state.decoder_state_tree(tr)
    assert packb(tree) == want
    chain = tree["opt_state"]["inner_state"]
    assert sorted(chain) == (["0", "1"] if runs["cfg"] else ["0", "1", "2"])


def test_port_file_restores_in_jax_near_its_state(runs):
    np.testing.assert_allclose(runs["plosses"], runs["losses"], rtol=1e-5)
    got = serialization.to_state_dict(jckpt.load_checkpoint(
        runs["ppath"], runs["init"]))
    decoder_close(got, runs["state3"], "port->jax")
    counts = {int(v) for p, v in train_state._leaves(got)
              if np.asarray(v).dtype == np.int32}
    assert counts == {3}


def test_jax_steps_on_from_the_port_file(runs):
    state = jtd.TrainState(**jckpt.load_checkpoint(runs["ppath"],
                                                   runs["init"]))
    batch = list(_batches())[3]
    state, loss, _ = runs["jtr"]._train_step(state, *map(jnp.asarray, batch))
    np.testing.assert_allclose(float(loss), runs["plosses"][3], rtol=1e-5)
    decoder_close(train_state.decoder_state_tree(runs["port"]),
                  serialization.to_state_dict(jax.device_get(state)),
                  "port step 4 vs jax from port file")


def test_port_restores_the_jax_file_bit_for_bit(runs, root):  # noqa: F811
    tr = _port_trainer(runs["v"], root, runs["dir"] / "b", **runs["cfg"])
    tr.ensure_ready(steps_per_epoch=2)
    tr.load_checkpoint(runs["jpath"])
    tree_bits(train_state.decoder_state_tree(tr), runs["state3"])
    assert tr.step_count == 3 and tr.scheduler.last_epoch == 3
    assert tr.optimizer.param_groups[0]["lr"] == 1e-4 * cosine_decay(3, 4)
    states = [tr.optimizer.state[p] for p in tr.model.decoder_parameters()]
    assert {float(s["step"]) for s in states} == {3.0}
    assert not any(p in tr.optimizer.state for p in tr.model.yolo.parameters())

    tr.step(*list(_batches())[3])
    assert tr.scheduler.last_epoch == 4
    decoder_close(train_state.decoder_state_tree(tr), runs["state4"],
                  "port from jax file, step 4")


def test_jax_file_round_trips_through_the_port_byte_for_byte(runs, root):  # noqa: F811
    tr = _port_trainer(runs["v"], root, runs["dir"] / "c", **runs["cfg"])
    tr.ensure_ready(steps_per_epoch=2)
    tr.load_checkpoint(runs["jpath"])
    out = str(runs["dir"] / "again.ckpt")
    tr._save(out)
    with open(out, "rb") as f, open(runs["jpath"], "rb") as g:
        assert f.read() == g.read()


def test_another_encoder_is_refused_by_name(runs, root):  # noqa: F811
    tree = unpackb(open(runs["jpath"], "rb").read())
    k = tree["params"]["yolo"]["model_0"]["conv"]["kernel"].copy()
    k.flat[0] = np.nextafter(k.flat[0], np.float32(1))     # one ulp
    tree["params"]["yolo"]["model_0"]["conv"]["kernel"] = k
    tr = _port_trainer(runs["v"], root, runs["dir"] / "d", **runs["cfg"])
    tr.ensure_ready(steps_per_epoch=2)
    with pytest.raises(ValueError, match="params/yolo/model_0/conv/kernel: "
                                         "the file's frozen encoder"):
        train_state.restore_decoder_state(tr, tree)
    other = dict(runs["cfg"])
    other["clip_grad_norm"] = None if other else CLIP
    tr = _port_trainer(runs["v"], root, runs["dir"] / "e", **other)
    tr.ensure_ready(steps_per_epoch=2)
    with pytest.raises(ValueError, match="opt_state/inner_state"):
        tr.load_checkpoint(runs["jpath"])


def test_resumed_train_matches_an_unbroken_run(variables, root, tmp_path):  # noqa: F811
    """A 3-epoch `train()` whose state after epoch 2 is written as the
    trainer writes its files, resumed in a fresh trainer of the same
    configuration: it starts at `step_count // steps_per_epoch` = 2 and
    its history and final state are the unbroken run's."""
    _, v = variables
    whole = _port_trainer(v, root, tmp_path / "whole", epochs=3)
    dump = whole._dump_history

    def dump_and_keep(run_dir):     # called at the end of every epoch
        dump(run_dir)
        if whole.step_count == 4:
            whole._save(str(tmp_path / "epoch2.ckpt"))
    whole._dump_history = dump_and_keep
    h = whole.train()
    rest = _port_trainer(v, root, tmp_path / "rest", epochs=3)
    h2 = rest.train(resume_from=str(tmp_path / "epoch2.ckpt"))
    assert rest.step_count == whole.step_count == 6
    for k in h2:
        assert len(h2[k]) == 1, k
        np.testing.assert_allclose(h2[k], h[k][2:], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    a = train_state.decoder_state_tree(rest)
    b = train_state.decoder_state_tree(whole)
    decoder_close(a, b, "resumed")
