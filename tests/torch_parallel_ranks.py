"""What the data-parallel tests run, in `launch`'s rank processes and, with
no mesh, in the test's own process: BatchNorm, a detector step, a decoder
update and validation, and the Evaluator, each from a picklable `spec`.

This module imports neither JAX nor the JAX package, so that a spawned rank
starts with torch and the port only. A rank returns what it alone holds
gathered over the ranks (outputs, input gradients), so that rank 0's result
is the whole of it.
"""

import contextlib

import numpy as np
import torch

from yolou_tpu_torch.data.augment import AugHyp
from yolou_tpu_torch.engine.evaluator import Evaluator
from yolou_tpu_torch.engine.trainer_decoder import (DecoderTrainConfig,
                                                    DecoderTrainer)
from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                     DetectorTrainer)
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.nn.blocks import BatchNorm2d
from yolou_tpu_torch.parallel import mesh as meshlib


def _tensors(state):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()}


def _state(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def batchnorm(spec, mesh=None):
    """A training-mode BatchNorm2d over `spec["x"]` (this rank's shard under
    a mesh), a backward of sum(y * spec["g"]): the whole output and input
    gradient, the parameter gradients (summed over the ranks) and the
    running statistics after two calls."""
    bn = BatchNorm2d(spec["x"].shape[1], eps=1e-3, momentum=0.03)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(spec["weight"]))
        bn.bias.copy_(torch.from_numpy(spec["bias"]))
    x, g = torch.from_numpy(spec["x"]), torch.from_numpy(spec["g"])
    if mesh is not None:
        x, g = meshlib.shard_batch(mesh, (x, g))
    x.requires_grad_(True)
    with mesh or contextlib.nullcontext():
        bn(x)
        y = bn(x)
    (y * g).sum().backward()
    if mesh is not None:
        meshlib.sum_gradients(mesh, bn.parameters())
    return {"y": meshlib.all_gather_rows(y, mesh),
            "x_grad": meshlib.all_gather_rows(x.grad, mesh),
            "weight_grad": bn.weight.grad, "bias_grad": bn.bias.grad,
            "running_mean": bn.running_mean.clone(),
            "running_var": bn.running_var.clone(),
            "num_batches_tracked": int(bn.num_batches_tracked)}


def detector_step(spec, mesh=None):
    """`DetectorTrainer.step` over the global batch `spec["batch"]` from the
    weights `spec["state_dict"]`: loss, parts, state_dict, EMA, counters and
    the gradient norm."""
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu")
    model.load_state_dict(_tensors(spec["state_dict"]), strict=True)
    tr = DetectorTrainer(model, None, DetectorTrainConfig(**spec["cfg"]),
                         aug=AugHyp(**spec["aug"]), device="cpu", mesh=mesh)
    tr.ensure_ready(steps_per_epoch=spec["steps_per_epoch"])
    gen = torch.Generator().manual_seed(spec["seed"])
    losses = []
    for batch in spec["batches"]:
        loss, parts = tr.step(batch, gen, use_mosaic=spec["use_mosaic"])
        losses.append((loss.item(), {k: v.item() for k, v in parts.items()}))
    return {"losses": losses, "state_dict": _state(model),
            "ema": tr.ema_variables(), "grad_norm": tr.grad_norm.item(),
            "counts": (tr.step_count, tr.opt_count, tr.total_notfinite)}


def _segpp(spec):
    model = build_segpp("yolov12", "n", nc=1, ch=4, device="cpu")
    model.load_state_dict(_tensors(spec["state_dict"]), strict=True)
    return model


def decoder_update(spec, mesh=None):
    """One `DecoderTrainer.step` over the global batch, then `validate` over
    `spec["val_batches"]` (the last padded): loss, Dice, the model's state
    and the validation metrics."""
    model = _segpp(spec)
    tr = DecoderTrainer(model, "", DecoderTrainConfig(**spec["cfg"]),
                        device="cpu", mesh=mesh)
    tr.ensure_ready(steps_per_epoch=1)
    loss, dice = tr.step(*spec["batch"])
    val = tr.validate(iter(spec["val_batches"]))
    return {"loss": loss.item(), "dice": dice.item(),
            "state_dict": _state(model), "val": val}


def evaluate(spec, mesh=None):
    """`Evaluator.accumulate` over `spec["batches"]` (the last padded), or
    `evaluate(split)` over the directory `spec["root"]`."""
    ev = Evaluator(_segpp(spec), spec.get("root", ""),
                   image_size=spec["size"], batch_size=spec["batch_size"],
                   device="cpu", mesh=mesh)
    if "root" in spec:
        return ev.evaluate(spec["split"], with_hd95=spec["hd95"])
    return ev.accumulate(iter(spec["batches"]), with_hd95=spec["hd95"])


def replicated(seed, mesh=None):
    """A Linear seeded by `seed` plus the rank, then `replicate`: every
    rank's weight (one row each)."""
    torch.manual_seed(seed + (0 if mesh is None else mesh.rank))
    lin = torch.nn.Linear(3, 2)
    if mesh is not None:
        meshlib.replicate(mesh, lin)
    return meshlib.all_gather_rows(lin.weight.detach().reshape(1, -1), mesh)


def in_ranks(jobs):
    """Every (name, spec) job of `jobs` under this rank's mesh."""
    mesh = meshlib.make_mesh()
    out = {"ranks": mesh.size, "backend": mesh.backend}
    for name, spec in jobs:
        out[name] = globals()[name.split(":")[0]](spec, mesh)
    return out


def uneven(spec):
    """A rank that raises, so the test can see launch re-raise it."""
    mesh = meshlib.make_mesh()
    if mesh.rank == spec:
        raise KeyError(f"rank {mesh.rank} stops here")
    meshlib.barrier(mesh)
    return mesh.rank


def numpy_state(state_dict):
    return {k: v.detach().cpu().numpy() for k, v in state_dict.items()}


def close(got, want, rtol, atol, what=""):
    """Every tensor of two state_dicts (or two tensors) within rtol / atol."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            close(got[k], want[k], rtol, atol, f"{what} {k}")
        return
    np.testing.assert_allclose(
        torch.as_tensor(got).detach().double().numpy(),
        torch.as_tensor(want).detach().double().numpy(), rtol=rtol, atol=atol,
        err_msg=what)
