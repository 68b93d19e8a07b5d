"""PyTorch port: the JAX package's default detector training state, the
flat form (`flat_opt=True`, SGD), read by the port; f32 on the CPU,
yolov12n-seg (4 ch, nc=1) at 64^2 and batch 2.

The JAX default trainer stores `ema_params` and the momentum as f32 vectors
in `ravel_pytree` order (`engine/flat_opt.py`). Its momentum is the same
trace as the tree form's in another layout, so the port restores it
exactly: after three JAX steps every tensor the port restores equals the
JAX vector's elements bit for bit (the EMA and the trace raveled back, the
params and statistics leaf for leaf), and the next step on each side, from
the restored state on the same batch, agrees within
`test_torch_port_train_state.py`'s tolerances. The port's own three steps
are held against the flat state the same way.
"""

import numpy as np
import pytest
from flax import serialization

from yolou_tpu.utils import checkpoint as jckpt
from yolou_tpu_torch.engine.trainer_detector import DetectorTrainConfig
from yolou_tpu_torch.utils import train_state

from .test_torch_port_train_state import (ATOL, KW, jax_runs, port_runs,
                                          port_step, port_trainer,
                                          tree_bits, tree_close,
                                          variables)  # noqa: F401
from .torch_threads import one_torch_thread  # noqa: F401


def flat_form(tree, cfg=DetectorTrainConfig(**KW)):
    """A port tree-form SGD state in the flat layout (as the JAX default
    trainer holds it)."""
    os_ = tree["opt_state"]
    groups = train_state._detector_chain(os_, cfg)["inner_states"]
    inner = {g: train_state._detector_group(groups[g], g, cfg)
             for g in train_state.GROUPS}
    trace = train_state._unmask(
        {g: inner[g]["inner_state"]["0"]["trace"] for g in inner},
        tree["params"])
    return {"params": tree["params"], "batch_stats": tree["batch_stats"],
            "ema_params": train_state.ravel(tree["ema_params"]),
            "opt_state": {"count": inner["bias"]["count"],
                          "mu": train_state.ravel(trace),
                          "notfinite": os_["notfinite_count"]},
            "step": tree["step"]}


@pytest.fixture(scope="module")
def runs(variables, tmp_path_factory):  # noqa: F811
    d = tmp_path_factory.mktemp("flat_state")
    jtr, init, state3, state4, losses = jax_runs(variables)
    assert jtr._flat is not None                 # the JAX default
    path = str(d / "jax_flat_last.ckpt")
    jckpt.save_checkpoint(path, state3)
    return dict(jtr=jtr, init=init, state3=state3, state4=state4,
                losses=losses, path=path, dir=d)


def test_the_jax_default_writes_the_flat_form(runs):
    tree = jckpt.load_checkpoint(runs["path"])
    assert train_state.state_form(tree) == "flat"
    assert sorted(tree["opt_state"]) == ["count", "mu", "notfinite"]
    assert tree["ema_params"].ndim == 1
    assert tree["ema_params"].shape == tree["opt_state"]["mu"].shape
    assert np.abs(tree["opt_state"]["mu"]).max() > 1e-2


def test_port_restores_the_flat_file_exactly(runs, variables):  # noqa: F811
    tr = port_trainer(variables)
    tr.load_resume(runs["path"])
    assert (tr.step_count, tr.opt_count, tr.notfinite_count()) == (3, 3, 0)
    assert tr.last_finite and tr.total_notfinite == 0
    tree_bits(flat_form(train_state.detector_state_tree(tr)), runs["state3"],
              "flat jax->port")


def test_port_next_step_from_the_flat_file_agrees(runs, variables):  # noqa: F811
    tr = port_trainer(variables)
    tr.load_resume(runs["path"])
    loss = port_step(tr, 3)
    np.testing.assert_allclose(loss, runs["losses"][3], rtol=1e-4)
    tree_close(flat_form(train_state.detector_state_tree(tr)),
               runs["state4"], ATOL, "port from flat file, step 4")


def test_port_steps_match_the_flat_state(runs, variables, tmp_path):  # noqa: F811
    _, state3, losses = port_runs(variables, str(tmp_path / "last.ckpt"))
    np.testing.assert_allclose(losses, runs["losses"], rtol=1e-4)
    tree_close(flat_form(state3), serialization.to_state_dict(
        runs["state3"]), ATOL, "port vs flat jax, step 3")
