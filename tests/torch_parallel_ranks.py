"""What the data-parallel and model-axis tests run, in `launch`'s rank
processes and, with no mesh, in the test's own process: BatchNorm, a
detector step, the detector's steps under any mesh (`trajectory`, which
`chip_smoke.py` runs on the card too), a decoder update and validation, and
the Evaluator, each from a picklable `spec`.

This module imports neither JAX nor the JAX package, so that a spawned rank
starts with torch and the port only. A rank returns what it alone holds
gathered over the ranks (outputs, input gradients), so that rank 0's result
is the whole of it.
"""

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from yolou_tpu_torch import kernels
from yolou_tpu_torch.data.augment import AugHyp
from yolou_tpu_torch.engine.evaluator import Evaluator
from yolou_tpu_torch.engine.trainer_decoder import (DecoderTrainConfig,
                                                    DecoderTrainer)
from yolou_tpu_torch.engine.trainer_detector import (DetectorTrainConfig,
                                                     DetectorTrainer)
from yolou_tpu_torch.models.segpp import build_segpp
from yolou_tpu_torch.models.yolo import build_yolo
from yolou_tpu_torch.nn.blocks import BatchNorm2d
from yolou_tpu_torch.nn.blocks import Conv
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


def _numbers(loss, parts):
    return float(loss), {k: float(v) for k, v in parts.items()}


def _host_copy(state):
    """Copies on the host (a CPU tensor's `.cpu()` would be itself)."""
    return {k: v.to("cpu", copy=True) for k, v in state.items()}


def per_rank(mesh, value):
    """Every rank's `value` in rank order (one rank: `[value]`)."""
    if meshlib.world_size(mesh) == 1:
        return [value]
    out = [None] * mesh.size
    dist.all_gather_object(out, value)
    return out


def _replicas_identical(mesh, tensors):
    """Whether every tensor is bit-identical in every rank of this rank's
    model group: one all-gather of them flattened, per dtype."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t.detach().reshape(-1))
    for flat in by_dtype.values():
        whole = meshlib._all_gather(mesh, torch.cat(flat)[None], mesh.n_model,
                                    mesh.model_group, 0)
        if not all(torch.equal(whole[0], w) for w in whole[1:]):
            return False
    return True


def trajectory(spec, mesh=None):
    """The steps of one yolov12n-seg `DetectorTrainer` (f32) over
    `spec["batches"]` (global numpy batches) from `spec["state_dict"]`
    (numpy), with `spec["cfg"]` / `spec["aug"]` (dicts), the augmentation
    generator seeded `spec["seed"]`, mosaic as `spec["use_mosaic"]`, and
    under a mesh with a model axis the weights cut by
    `param_sharding_rules(min_size=spec["min_size"])`. On `spec["device"]`
    without a mesh, the mesh's device with one.

    Optional: `spec["resume"]`, a training-state file read before the
    first step; `spec["ckpt_dir"]` writes `<tag>_init.ckpt` before the
    first step and `<tag>_last.ckpt` after the last (tag `spec["tag"]`);
    `spec["twin"]` = (batch, seed) takes one more step after that, with a
    generator of that seed.

    Returns losses [(loss, parts)], grad_norms, counts, the whole
    state_dict and EMA, and per rank: cut weights, parameter bytes, kernel
    C's forward launches and backward calls of each step, and whether the
    replicated tensors are bit-identical across its model group."""
    device = mesh.device if mesh is not None else spec.get("device")
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device=device)
    model.load_state_dict(_tensors(spec["state_dict"]))
    rules = None
    if mesh is not None and mesh.n_model > 1:
        rules = meshlib.param_sharding_rules(mesh, model,
                                             min_size=spec["min_size"])
    tr = DetectorTrainer(model, None, DetectorTrainConfig(**spec["cfg"]),
                         aug=AugHyp(**spec.get("aug", {})), device=device,
                         mesh=mesh, sharding=rules)
    tr.ensure_ready(steps_per_epoch=spec.get("steps_per_epoch", 2))
    if spec.get("resume"):
        tr.load_resume(spec["resume"])
    tag, ckpt_dir = spec.get("tag", "one"), spec.get("ckpt_dir")
    if ckpt_dir:
        tr.save_checkpoint(os.path.join(ckpt_dir, f"{tag}_init.ckpt"))
    gen = torch.Generator(device=tr.device).manual_seed(spec["seed"])
    losses, norms, launches = [], [], []
    for batch in spec["batches"]:
        kernels.reset_launch_counts()
        losses.append(_numbers(*tr.step(batch, gen, spec["use_mosaic"])))
        norms.append(float(tr.grad_norm))
        launches.append((kernels.launch_counts()["band_attention_train"],
                         kernels.backward_counts()["band_attention_train"]))
    out = {"losses": losses, "grad_norms": norms,
           "counts": (tr.step_count, tr.opt_count, tr.total_notfinite),
           "ema": _host_copy(tr.ema_variables()),
           "state_dict": _host_copy(meshlib.gathered_state(mesh, model))}
    cut = meshlib.model_shards(model)
    replicated = [t for n, t in [*model.named_parameters(),
                                 *model.named_buffers()] if n not in cut]
    rank = {"n_cut": len(cut),
            "param_bytes": sum(p.numel() * p.element_size()
                               for p in model.parameters()),
            "launches": launches,
            "replicas_identical": (mesh is None or mesh.n_model == 1
                                   or _replicas_identical(mesh, replicated))}
    out["ranks"] = per_rank(mesh, rank)
    if ckpt_dir:
        tr.save_checkpoint(os.path.join(ckpt_dir, f"{tag}_last.ckpt"))
    if "twin" in spec:
        batch, seed = spec["twin"]
        out["twin"] = _numbers(*tr.step(
            batch, torch.Generator(device=tr.device).manual_seed(seed),
            spec["use_mosaic"]))
        out["twin_state"] = _host_copy(meshlib.gathered_state(mesh, model))
    return out


def layout(spec, mesh):
    """Every rank's (rank, data index, model index) and the ranks of its
    data and model groups."""
    import torch.distributed as dist
    mine = (mesh.rank, mesh.data_index, mesh.model_index,
            dist.get_process_group_ranks(mesh.data_group),
            dist.get_process_group_ranks(mesh.model_group))
    out = [None] * mesh.size
    dist.all_gather_object(out, mine)
    return out


def depthwise(spec, mesh=None):
    """A depthwise 7x7 `Conv` (BatchNorm in eval mode) over `spec["x"]`,
    with its weight cut over the model axis under a mesh: the whole output,
    input gradient of sum(y * spec["g"]) and weight gradient."""
    conv = Conv(spec["c"], spec["c"], 7, g=spec["c"]).eval()
    with torch.no_grad():
        conv.conv.weight.copy_(torch.from_numpy(spec["weight"]))
    x, g = torch.from_numpy(spec["x"]), torch.from_numpy(spec["g"])
    if mesh is not None:
        meshlib.shard_module(mesh, conv, meshlib.param_sharding_rules(
            mesh, conv, min_size=1))
        x, g = meshlib.shard_batch(mesh, (x, g))
    x.requires_grad_(True)
    with mesh or contextlib.nullcontext():
        y = conv(x)
    (y * g).sum().backward()
    grads = {"conv.weight": conv.conv.weight.grad}
    if mesh is not None:
        meshlib.sum_gradients(mesh, [conv.conv.weight])
        grads = meshlib.gathered_state(mesh, conv, grads)
    return {"y": meshlib.all_gather_rows(y.detach(), mesh),
            "x_grad": meshlib.all_gather_rows(x.grad, mesh),
            "weight_grad": grads["conv.weight"],
            "cut": tuple(conv.conv.weight.shape)}


def detector_train(spec, mesh=None):
    """`DetectorTrainer.train()` over the data directory `spec["yaml"]`
    with validation every epoch (under a model axis, the weights cut by
    `param_sharding_rules(min_size=spec["min_size"])`): the history, the
    run's weights directory and the trained state, whole."""
    import os
    from yolou_tpu_torch.data.config import load_data_yaml
    model = build_yolo("yolov12", "n", nc=1, ch=4, task="segment",
                       device="cpu", seed=2)
    rules = None
    if mesh is not None and mesh.n_model > 1:
        rules = meshlib.param_sharding_rules(mesh, model,
                                             min_size=spec["min_size"])
    tr = DetectorTrainer(model, load_data_yaml(spec["yaml"]),
                         DetectorTrainConfig(**spec["cfg"]),
                         aug=AugHyp(scale=0.3), device="cpu", mesh=mesh,
                         sharding=rules)
    history = tr.train()
    run_dir = spec["cfg"]["run_dir"]
    runs = sorted(os.listdir(run_dir)) if os.path.isdir(run_dir) else []
    return {"history": history,
            "weights": os.path.join(run_dir, runs[-1], "weights")
            if runs else None,
            "state_dict": {k: v.to("cpu", copy=True) for k, v in
                           meshlib.gathered_state(mesh, model).items()}}


def in_mesh(jobs, n_data, n_model):
    """Every (name, spec) job of `jobs` under an n_data x n_model mesh."""
    mesh = meshlib.make_mesh(n_data, n_model)
    out = {"ranks": mesh.size, "shape": mesh.shape}
    for name, spec in jobs:
        out[name] = globals()[name.split(":")[0]](spec, mesh)
    return out


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
