"""Data parallel: a batch sharded over ranks, a step equal to one process's.

Counterpart of `yolou_tpu/parallel/mesh.py`. There a mesh step is one SPMD
program whose math is that of one device on the global batch. Here each
rank is a process of a `torch.distributed` group that holds the whole
model; `launch` starts the ranks and `make_mesh`, called inside each,
describes its place. Batches are cut along the leading axis into
contiguous shards in rank order, as `NamedSharding(P("data"))` cuts them
(`shard_batch`), and what couples the images of a batch is made global:

- BatchNorm's batch statistics: under an active mesh (`with mesh:`),
  `nn/blocks.py::BatchNorm2d` all-reduces the per-channel sum and sum of
  squares and takes flax's variance E[x^2] - E[x]^2 over the global batch;
- the losses' batch-global normalizers (`losses/v8.py`) and sums
  (`losses/dice.py`) go through `global_sum`;
- augmentation, which mixes the images of a batch, runs on the whole global
  batch on every rank with the same generator state before the rank takes
  its shard (`engine/trainer_detector.py`).

The one reduction rule of both trainers: each rank's loss is its *share* of
the global loss, and the global loss is the sum of the shares. A share keeps
the numerators of the rank's own images over the global normalizers; a loss
that is a function of global sums only (soft Dice, Tversky) gives each rank
1/N of it. `global_sum` is an all-reduce whose backward all-reduces the
cotangents, so the gradient of a share is the rank's part of the global
gradient, and `sum_gradients` adds the parts: parameter gradients are
summed over the ranks, never averaged. Clipping, the non-finite skip, the
optimizer and the EMA then see the same gradients on every rank.

Backends: NCCL where every rank has a card of its own; gloo on the CPU and
where ranks share a card (NCCL refuses two ranks on one GPU). gloo reduces
and broadcasts CUDA tensors but gathers only CPU ones, so `all_gather_rows`
gathers through the host there. A mesh of one rank computes exactly what
no mesh computes: every collective is skipped.

A model axis (`make_mesh(n_data, n_model)`, n_model > 1) lays the ranks
out as JAX's `reshape(n_data, n_model)` of the device list: rank r is at
data index r // n_model and model index r % n_model. The ranks of one data
row (a *model group*) hold the same batch shard, so every collective above
goes over a *data group* (the ranks of one model index), never over the
world; on a 1-D mesh the data group is the world. `param_sharding_rules`
picks the large conv weights, `shard_module` keeps each model rank's
contiguous slice of their output channels, and `nn/blocks.py` runs such a
conv on its slice and all-gathers the result over the model group
(`gather_from_model`), so that everything after it runs whole and
identically in every model rank. `gathered_state` puts the slices back
together for files and validation.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import os
import pickle
import queue as queuelib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.utils import _pytree as pytree

_STACK: List["Mesh"] = []                # meshes entered with `with mesh:`
_RANK_DEVICE: Optional[torch.device] = None   # this rank's, set by launch
# the cut convs' collectives over the model group in this process: forward
# all-gathers and backward all-reduces, and the host seconds they took
model_comm = {"gathers": 0, "reduces": 0, "seconds": 0.0}


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in a group of ranks: its rank, the number of
    ranks (`size`), its device, the group's backend and the length of the
    model axis. `with mesh:` makes it the active mesh, which BatchNorm, the
    losses and the sharded convs consult."""
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool = False     # make_mesh started the group itself
    n_model: int = 1
    data_group: Any = None       # this rank's data group; None: the world
    model_group: Any = None      # this rank's model group (n_model > 1)

    @property
    def n_data(self) -> int:
        return self.size // self.n_model

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def __enter__(self) -> "Mesh":
        _STACK.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _STACK.pop()

    def close(self) -> None:
        """End the process group where `make_mesh` started it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
            self.owns_group = False


def active_mesh() -> Optional[Mesh]:
    return _STACK[-1] if _STACK else None


def world_size(mesh: Optional[Mesh] = None) -> int:
    """The number of ranks of `mesh`, else of the active mesh; 1 without."""
    mesh = mesh or active_mesh()
    return 1 if mesh is None else mesh.size


def data_size(mesh: Optional[Mesh] = None) -> int:
    """The length of the data axis of `mesh`, else of the active mesh (the
    number of batch shards); 1 without."""
    mesh = mesh or active_mesh()
    return 1 if mesh is None else mesh.n_data


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL where every rank has a CUDA device of its own, gloo on the CPU
    and where ranks share a card."""
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on {sorted(kinds)}: all on the CPU or all "
                         f"on CUDA devices")
    indices = [d.index if d.index is not None else 0 for d in devices]
    return "nccl" if len(set(indices)) == len(indices) else "gloo"


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices=None) -> Mesh:
    """This rank's mesh. Inside `launch`'s ranks it describes the group
    launch started as an `n_data` x `n_model` grid (`n_data` defaults to
    size // n_model; the product must be the size), the ranks in JAX's
    `reshape(n_data, n_model)` order. Elsewhere only a mesh of one is
    possible, and its group is started here, on `devices[0]` or else the
    GPU (an error where there is none).

    With a model axis every rank makes every data group and every model
    group (`dist.new_group` in the same order in every rank, as it must be
    called), on the group's backend."""
    owns = False
    if not dist.is_initialized():
        if n_data not in (None, 1) or n_model != 1:
            raise RuntimeError(
                f"make_mesh(n_data={n_data}, n_model={n_model}) outside a "
                f"group of ranks: start them with "
                f"yolou_tpu_torch.parallel.mesh.launch")
        if devices is not None:
            device = torch.device(list(devices)[0])
        elif _RANK_DEVICE is not None:
            device = _RANK_DEVICE
        else:
            from ..models.yolo import resolve_device
            device = resolve_device(None)
        backend = backend_for([device])
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
        owns = True
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_model < 1 or size % n_model:
        raise ValueError(f"make_mesh(n_model={n_model}) in a group of {size} "
                         f"ranks")
    if n_data is not None and n_data * n_model != size:
        raise ValueError(f"make_mesh(n_data={n_data}, n_model={n_model}) in "
                         f"a group of {size} ranks")
    if devices is not None:
        device = torch.device(list(devices)[rank])
    elif _RANK_DEVICE is not None:
        device = _RANK_DEVICE
    mesh = Mesh(rank, size, device, dist.get_backend(), owns, n_model)
    if n_model > 1:
        grid = np.arange(size).reshape(size // n_model, n_model)
        for m in range(n_model):
            group = dist.new_group(grid[:, m].tolist(), backend=mesh.backend)
            if m == mesh.model_index:
                mesh.data_group = group
        for d in range(size // n_model):
            group = dist.new_group(grid[d].tolist(), backend=mesh.backend)
            if d == mesh.data_index:
                mesh.model_group = group
    return mesh


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a mesh lays out an array: cut along dimension `dim` into `size`
    contiguous parts, of which this rank holds part `rank` (`axis` "data":
    a batch over the data axis; "model": a weight over the model axis), or
    whole on each (`axis` None)."""
    axis: Optional[str]
    rank: int
    size: int
    dim: int = 0

    def index(self, n: int) -> slice:
        """This rank's part of a dimension of length `n`."""
        if self.axis is None:
            return slice(None)
        if n % self.size:
            what = "a batch" if self.axis == "data" else "a dimension"
            raise ValueError(f"{what} of {n} does not split over "
                             f"{self.size} ranks (pad_batch_to_multiple)")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)

    def take(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of `t` (a view)."""
        if self.axis is None:
            return t
        return t[(slice(None),) * self.dim + (self.index(t.shape[self.dim]),)]


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding over the data axis."""
    return Sharding("data", mesh.data_index, mesh.n_data)


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(None, mesh.rank, mesh.size)


def shard_batch(mesh: Mesh, batch):
    """This rank's contiguous shard of every array or tensor of a (nested)
    batch, as a tensor on the mesh's device (None stays None)."""
    sh = batch_sharding(mesh)
    return pytree.tree_map(
        lambda x: None if x is None else torch.as_tensor(
            x[sh.index(len(x))]).to(mesh.device), batch)


def _coalesced(tensors: List[torch.Tensor], collective) -> None:
    """Run `collective` on one flat buffer per dtype and device, and copy
    the result back into `tensors` in place."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        flat = _flatten_dense_tensors(ts)
        collective(flat)
        for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(r)


def replicate(mesh: Mesh, module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers in `module` on every rank, in
    place."""
    if mesh.size > 1:
        with torch.no_grad():
            _coalesced(list(module.state_dict().values()),
                       lambda flat: dist.broadcast(flat, src=0))
    return module


def pad_batch_to_multiple(batch, multiple: int):
    """Pad the leading axis of a (nested) numpy batch to a multiple of the
    data-axis size by repeating the first row; returns (padded_batch,
    n_real)."""
    b = pytree.tree_leaves(batch)[0].shape[0]
    rem = b % multiple
    if rem == 0:
        return batch, b
    pad = multiple - rem

    def padfn(x):
        return np.concatenate([x, np.repeat(x[:1], pad, axis=0)], axis=0)

    return pytree.tree_map(padfn, batch), b


class _SumOverRanks(torch.autograd.Function):
    """All-reduce SUM over `group`; the backward all-reduces the
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        t0 = time.perf_counter()
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        model_comm["reduces"] += 1
        model_comm["seconds"] += time.perf_counter() - t0
        return g, None


def global_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`x` summed over the data group of `mesh`, else of the active mesh,
    with autograd; `x` itself without a mesh or with one batch shard."""
    mesh = mesh or active_mesh()
    if data_size(mesh) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverRanks.apply(x, mesh.data_group)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.data_group)
    return y


def _all_gather(mesh: Mesh, x: torch.Tensor, n: int, group,
                dim: int) -> torch.Tensor:
    """The `n` ranks of `group`'s `x` concatenated along `dim` in rank order,
    on `x`'s device (through the host under gloo, which gathers only CPU
    tensors); no autograd."""
    src = x.detach().contiguous()
    if mesh.backend != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(x.device)


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> torch.Tensor:
    """Every data shard's `x` (the same shape on each) concatenated along
    the leading axis in data order, on `x`'s device (through the host under
    gloo); no autograd."""
    mesh = mesh or active_mesh()
    if data_size(mesh) == 1:
        return x
    return _all_gather(mesh, x, mesh.n_data, mesh.data_group, 0)


def sum_gradients(mesh: Mesh, params) -> None:
    """Sum the `.grad` of `params` over the data group, in place (one flat
    all-reduce per dtype)."""
    if mesh.n_data == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        _coalesced(grads, lambda flat: dist.all_reduce(
            flat, group=mesh.data_group))


def mean_over_model(mesh: Mesh, params) -> None:
    """Average the `.grad` of `params` over the model group, in place (the
    replicated parameters under a model axis)."""
    if mesh.n_model == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        _coalesced(grads, lambda flat: dist.all_reduce(
            flat, group=mesh.model_group))
        torch._foreach_div_(grads, float(mesh.n_model))


def sum_over_model(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` summed over the model group (no autograd)."""
    if mesh.n_model == 1:
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=mesh.model_group)
    return y


def from_main(mesh: Optional[Mesh], obj):
    """Rank 0's `obj` in every rank (a picklable object; `obj` itself
    without a mesh or in a mesh of one)."""
    if world_size(mesh) == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def barrier(mesh: Optional[Mesh]) -> None:
    if world_size(mesh) > 1:
        dist.barrier()


# -------------------------------------------------------------- model axis

def param_sharding_rules(mesh: Mesh, params, min_size: int = 2 ** 16
                         ) -> Dict[str, Sharding]:
    """The JAX package's tensor-parallel rule in torch terms: a weight is cut
    over "model" along its output-channel axis when the mesh has a model
    axis, it has two dimensions or more, at least `min_size` elements and
    an output axis that splits evenly; everything else is replicated.

    `params` is a module (its parameters) or a name -> tensor mapping. The
    output axis is torch's dim 0 (flax's last axis of a conv kernel, so the
    same leaves qualify), and dim 1 for the weight of a transposed conv of
    a module. Returns name -> `Sharding` ("model", the rank's model index,
    n_model, dim) or `replicated(mesh)`."""
    n = mesh.n_model
    if isinstance(params, torch.nn.Module):
        transposed = {f"{name}.weight" if name else "weight"
                      for name, m in params.named_modules()
                      if isinstance(m, torch.nn.modules.conv._ConvTransposeNd)}
        params = dict(params.named_parameters())
    else:
        transposed = set()
    rules = {}
    for name, t in params.items():
        dim = 1 if name in transposed else 0
        if (n > 1 and t.ndim >= 2 and t.numel() >= min_size
                and t.shape[dim] % n == 0):
            rules[name] = Sharding("model", mesh.model_index, n, dim)
        else:
            rules[name] = replicated(mesh)
    return rules


def shard_module(mesh: Mesh, module: torch.nn.Module,
                 rules: Dict[str, Sharding]) -> torch.nn.Module:
    """Keep in this rank only its slice of every weight `rules` cuts over
    "model" (the counterpart of `tree_map(jax.device_put, state, rules)`):
    the weight becomes a smaller `nn.Parameter`, its conv records the cut as
    `model_shard`, and `module.model_shards` maps the names to their cuts.
    Only conv weights are cut, along their output channels; a grouped conv
    only where its groups split over the model axis. In place; returns
    `module`."""
    shards = dict(getattr(module, "model_shards", {}))
    for name, sh in rules.items():
        if sh.axis != "model":
            continue
        owner, _, leaf = name.rpartition(".")
        conv = module.get_submodule(owner)
        if (leaf != "weight" or name in shards
                or not isinstance(conv, (torch.nn.Conv2d,
                                         torch.nn.ConvTranspose2d))
                or conv.padding_mode != "zeros"):
            raise ValueError(f"{name}: only the weight of a zero-padded 2-D "
                             f"conv is cut over the model axis, once")
        if isinstance(conv, torch.nn.ConvTranspose2d):
            fits = sh.dim == 1 and conv.groups == 1
        else:
            fits = sh.dim == 0 and (conv.groups == 1
                                    or conv.groups % sh.size == 0)
        if not fits:
            raise ValueError(
                f"{name}: a cut along dim {sh.dim} of a "
                f"{type(conv).__name__} with {conv.groups} groups over "
                f"{sh.size} ranks is not its output channels")
        w = conv.weight
        conv.weight = torch.nn.Parameter(sh.take(w.detach()).clone(),
                                         requires_grad=w.requires_grad)
        conv.model_shard = sh
        shards[name] = sh
    module.model_shards = shards
    return module


def model_shards(module: torch.nn.Module) -> Dict[str, Sharding]:
    """name -> cut of the weights `shard_module` cut in `module`."""
    return getattr(module, "model_shards", {})


def local_part(module: torch.nn.Module, name: str,
               t: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole tensor `t` of parameter `name` where
    `module` holds that parameter cut, else `t`."""
    sh = model_shards(module).get(name)
    return t if sh is None else sh.take(t)


def gathered_state(mesh: Optional[Mesh], module: torch.nn.Module,
                   tensors: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """`module`'s state_dict, or `tensors` named as its parameters (EMA,
    optimizer moments), with every slice `shard_module` left in this rank
    all-gathered over the model group into its whole tensor, detached. A
    collective where anything is cut: every rank calls it."""
    src = module.state_dict() if tensors is None else tensors
    shards = model_shards(module)
    return {name: (t.detach() if name not in shards else _all_gather(
                mesh, t, mesh.n_model, mesh.model_group, shards[name].dim))
            for name, t in src.items()}


def whole_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A deep copy of `module` with whole-shape (uninitialised) parameters
    in place of its cut ones and no record of a cut: load a gathered state
    into it."""
    out = copy.deepcopy(module)
    for name, sh in model_shards(out).items():
        owner, _, leaf = name.rpartition(".")
        conv = out.get_submodule(owner)
        w = conv.weight
        shape = list(w.shape)
        shape[sh.dim] *= sh.size
        conv.weight = torch.nn.Parameter(w.new_empty(shape),
                                         requires_grad=w.requires_grad)
        del conv.model_shard
    out.model_shards = {}
    return out


def model_mesh(what: str) -> Mesh:
    """The active mesh, which a cut weight needs for its model group."""
    mesh = active_mesh()
    if mesh is None or mesh.n_model == 1:
        raise RuntimeError(f"{what} holds a slice of a weight cut over the "
                           f"model axis: run it inside `with mesh:` of its "
                           f"mesh")
    return mesh


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward all-reduces the cotangent over the model
    group, adding up the input gradients of the ranks' output slices."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.group = mesh.model_group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        t0 = time.perf_counter()
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        model_comm["reduces"] += 1
        model_comm["seconds"] += time.perf_counter() - t0
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """All-gather over the model group along `dim`; the backward returns
    this rank's slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.k, ctx.index = dim, x.shape[dim], mesh.model_index
        return _all_gather(mesh, x, mesh.n_model, mesh.model_group, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.index * ctx.k, ctx.k), None, None


def copy_to_model(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The input of a cut conv: itself, with the input gradients summed
    over the model group in the backward."""
    return _CopyToModel.apply(x, mesh) if x.requires_grad else x


def gather_from_model(x: torch.Tensor, mesh: Mesh,
                      dim: int = 1) -> torch.Tensor:
    """The ranks' output slices of a cut conv, all-gathered over the model
    group along `dim` into the whole output, with autograd: the backward
    hands each rank its slice of the cotangent. That is the gradient only
    because everything after the gather is computed identically in every
    rank of the model group (the same batch shard, the same augmentation
    generator, the same loss), so the cotangent of the whole output is the
    same in each."""
    t0 = time.perf_counter()
    if torch.is_grad_enabled() and x.requires_grad:
        y = _GatherFromModel.apply(x, mesh, dim)
    else:
        y = _all_gather(mesh, x, mesh.n_model, mesh.model_group, dim)
    model_comm["gathers"] += 1
    model_comm["seconds"] += time.perf_counter() - t0
    return y


# ------------------------------------------------------------------ launch

def _pickled_error(e: BaseException) -> bytes:
    try:
        blob = pickle.dumps(e)
        pickle.loads(blob)
        return blob
    except Exception:
        return pickle.dumps(RuntimeError(f"{type(e).__name__}: {e}"))


def _rank_main(rank: int, devices: List[torch.device], backend: str,
               store: str, threads: int, timeout: Optional[float],
               fn: Callable,
               args: tuple, results) -> None:
    global _RANK_DEVICE
    torch.set_num_threads(threads)
    n = len(devices)
    try:
        device = devices[rank]
        if device.type == "cuda":
            torch.cuda.set_device(device)
        _RANK_DEVICE = device
        kw = {"device_id": device} if backend == "nccl" else {}
        dist.init_process_group(
            backend, init_method="file://" + store, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout or 1800), **kw)
        out = fn(*args)
        msg = (rank, True, pickle.dumps(out) if rank == 0 else None)
    except BaseException as e:
        msg = (rank, False, (_pickled_error(e), traceback.format_exc()))
    results.put(msg)
    if msg[1] and dist.is_initialized():
        dist.destroy_process_group()


def launch(fn: Callable, n_data: int, devices=None, *args,
           timeout: Optional[float] = 900.0):
    """Run `fn(*args)` in `n_data` rank processes (start method spawn), rank
    r on `devices[r]` (default: CUDA devices 0 ... n_data - 1, one a rank),
    each in a `torch.distributed` group of `backend_for(devices)` and with
    this process's number of torch threads; `fn` calls `make_mesh` for its
    mesh. Returns rank 0's return value (pickled back). A rank's exception
    is raised here with its traceback as a note, after the other ranks are
    stopped; so is a rank that dies without one, and ranks that have not
    finished after `timeout` seconds (TimeoutError; None waits as long as
    they live, and a collective that hangs fails after 30 minutes)."""
    if devices is None:
        if torch.cuda.device_count() < n_data:
            raise RuntimeError(
                f"launch: {n_data} ranks need {n_data} CUDA devices, "
                f"{torch.cuda.device_count()} here; pass devices to share "
                f"one or run on the CPU")
        devices = [f"cuda:{i}" for i in range(n_data)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n_data:
        raise ValueError(f"launch: {n_data} ranks, {len(devices)} devices")
    backend = backend_for(devices)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="yolou_mesh_")
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(rank, devices, backend, os.path.join(tmp, "rendezvous"),
              torch.get_num_threads(), timeout, fn, args, results))
        for rank in range(n_data)]
    try:
        for p in procs:
            p.start()
        return _collect(procs, results, timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is None:           # never started
                continue
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _collect(procs, results, timeout: Optional[float]):
    deadline = time.monotonic() + (timeout if timeout else float("inf"))
    n = len(procs)
    done: dict = {}
    dead_since: dict = {}
    while len(done) < n:
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queuelib.Empty:
            now = time.monotonic()
            for r, p in enumerate(procs):
                if r in done or p.exitcode is None:
                    continue
                # a result put just before the exit may still be in the pipe
                if now - dead_since.setdefault(r, now) > 2.0:
                    raise RuntimeError(
                        f"launch: rank {r} of {n} exited with code "
                        f"{p.exitcode} without a result")
            if now > deadline:
                missing = sorted(set(range(n)) - set(done))
                raise TimeoutError(f"launch: ranks {missing} of {n} had not "
                                   f"finished after {timeout} s")
            continue
        if not ok:
            blob, tb = payload
            exc = pickle.loads(blob)
            exc.add_note(f"raised in rank {rank} of {n}:\n{tb}")
            raise exc
        done[rank] = payload
    return pickle.loads(done[0])
