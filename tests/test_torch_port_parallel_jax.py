"""PyTorch port: the detector step on two gloo ranks, and on four as a
2 x 2 data x model mesh (99 weights cut over the model axis), against the
JAX package's 8-device mesh step (the conftest's virtual CPU devices), f32
on the CPU.

`tests/test_trainer_detector.py`'s mesh test setup (yolov12n-seg at 64^2,
global batch 8, 4 instances, warmup 0.1 epoch, no non-finite skip) with
augmentation off on both sides (as in `test_torch_port_trainer.py`), one
step from the same JAX variables: the loss and its parts within rtol 3e-4,
parameters and BatchNorm statistics within rtol 1e-3 / atol 5e-5, that
test's tolerances. Both meshes are held against the one JAX data-parallel
step: a JAX dp x tp step computes the same function and compiles for
minutes on a CPU host. The ranks run while the JAX step compiles.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from yolou_tpu.data.augment import AugHyp as JaxAugHyp
from yolou_tpu.engine import trainer_detector as jtd
from yolou_tpu.models.yolo import build_yolo as build_yolo_jax
from yolou_tpu.parallel import mesh as jmesh
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.parallel import mesh as meshlib
from yolou_tpu_torch.tools import convert
from yolou_tpu_torch.tools.convert import state_dict_from_jax

from . import torch_parallel_ranks as ranks
from .test_torch_port_slice import jax_variables
from .test_torch_port_trainer import OFF
from .torch_threads import one_torch_thread  # noqa: F401

S, BATCH = 64, 8


def _batch():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (BATCH, S, S, 4), dtype=np.uint8)
    idmap = np.zeros((BATCH, S, S), np.int32)
    idmap[:, 16:40, 16:48] = 1
    cls = np.zeros((BATCH, 4), np.int32)
    valid = np.zeros((BATCH, 4), bool)
    valid[:, 0] = True
    return img, idmap, cls, valid


@pytest.fixture(scope="module")
def steps():
    """The JAX mesh step, and the port's step on two ranks ("dp") and on a
    2 x 2 mesh ("2x2") from the same variables and batch."""
    jdet = build_yolo_jax("yolov12", "n", nc=1, ch=4, task="segment")
    variables = jax_variables(jdet, seed=3)
    cfg = dict(imgsz=S, batch_size=BATCH, epochs=1, close_mosaic=0,
               max_instances=4, warmup_epochs=0.1, skip_nonfinite=False)
    spec = {"state_dict": ranks.numpy_state(state_dict_from_jax(variables)),
            "cfg": cfg, "aug": OFF, "steps_per_epoch": 2, "seed": 0,
            "use_mosaic": False, "batches": [_batch()]}
    out = {}
    port = [threading.Thread(target=lambda: out.update(dp=meshlib.launch(
                ranks.in_ranks, 2, ["cpu", "cpu"], [("detector_step", spec)],
                timeout=300))),
            threading.Thread(target=lambda: out.update({"2x2": meshlib.launch(
                ranks.in_mesh, 4, ["cpu"] * 4,
                [("trajectory", dict(spec, min_size=2 ** 12))], 2, 2,
                timeout=300)}))]
    for t in port:
        t.start()
    try:
        mesh = jmesh.make_mesh(n_data=8)
        jtr = jtd.DetectorTrainer(
            jdet, variables, None,
            jtd.DetectorTrainConfig(flat_opt=False, device_data=False,
                                    packed_upload=False, **cfg),
            aug=JaxAugHyp(**OFF), mesh=mesh)
        jtr.data_cfg = type("D", (), {"channels": 4})()
        jtr.ensure_ready(steps_per_epoch=2)
        jtr.state = jmesh.replicate(mesh, jtr.state)
        batch = jmesh.shard_batch(mesh,
                                  tuple(jnp.asarray(a) for a in _batch()))
        state, loss, parts = jtr._step[False](jtr.state, batch,
                                              jax.random.key(3))
        out["jax"] = (jax.device_get(state), float(loss),
                      {k: float(v) for k, v in parts.items()})
    finally:
        for t in port:
            t.join()
    return out


def _matches_the_jax_step(step, jax_step):
    want, loss, parts = jax_step
    assert step["counts"] == (1, 1, 0)
    got_loss, got_parts = step["losses"][0]
    np.testing.assert_allclose(got_loss, loss, rtol=3e-4)
    for k in ("box", "cls", "dfl", "seg"):
        assert parts[k] > 0, k
        np.testing.assert_allclose(got_parts[k], parts[k], rtol=3e-4,
                                   err_msg=k)
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    model.load_state_dict(step["state_dict"], strict=True)
    got = convert.jax_variables(model)
    for what in ("params", "batch_stats"):
        flat_g = jax.tree_util.tree_leaves_with_path(got[what])
        flat_w = jax.tree_util.tree_leaves_with_path(getattr(want, what))
        assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
        for (path, a), (_, b) in zip(flat_g, flat_w):
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), rtol=1e-3, atol=5e-5,
                err_msg=f"{what} {jax.tree_util.keystr(path)}")


def test_detector_step_matches_the_jax_mesh_step(steps):
    assert steps.get("dp", {}).get("ranks") == 2, \
        "the ranks failed (see the traceback)"
    _matches_the_jax_step(steps["dp"]["detector_step"], steps["jax"])


def test_2x2_step_matches_the_jax_mesh_step(steps):
    run = steps.get("2x2", {})
    assert run.get("shape") == {"data": 2, "model": 2}, \
        "the ranks failed (see the traceback)"
    step = run["trajectory"]
    assert all(r["n_cut"] == 99 for r in step["ranks"])
    _matches_the_jax_step(step, steps["jax"])
