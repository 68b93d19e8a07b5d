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

Not ported: a "model" axis (`n_model > 1`, the JAX package's
`param_sharding_rules`, which shards large kernels over it).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue as queuelib
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors
from torch.utils import _pytree as pytree

_STACK: List["Mesh"] = []                # meshes entered with `with mesh:`
_RANK_DEVICE: Optional[torch.device] = None   # this rank's, set by launch


@dataclasses.dataclass(eq=False)
class Mesh:
    """This process's place in a data-parallel group: its rank, the number
    of ranks (`size`), its device and the group's backend. `with mesh:`
    makes it the active mesh, which BatchNorm and the losses consult."""
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool = False     # make_mesh started the group itself

    @property
    def shape(self) -> dict:
        return {"data": self.size, "model": 1}

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
    launch started (`n_data`, where given, must be its size). Elsewhere only
    a mesh of one is possible, and its group is started here, on
    `devices[0]` or else the GPU (an error where there is none)."""
    if n_model != 1:
        raise NotImplementedError(
            f"n_model={n_model}: model-axis sharding (the JAX package's "
            f"param_sharding_rules) is not ported; data parallel only")
    owns = False
    if not dist.is_initialized():
        if n_data not in (None, 1):
            raise RuntimeError(
                f"make_mesh(n_data={n_data}) outside a group of ranks: start "
                f"them with yolou_tpu_torch.parallel.mesh.launch")
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
    if n_data is not None and n_data != size:
        raise ValueError(f"make_mesh(n_data={n_data}) in a group of {size} "
                         f"ranks")
    if devices is not None:
        device = torch.device(list(devices)[rank])
    elif _RANK_DEVICE is not None:
        device = _RANK_DEVICE
    return Mesh(rank, size, device, dist.get_backend(), owns)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How a mesh lays out an array: cut along the leading axis over the
    ranks (`axis` "data"), or whole on each (`axis` None)."""
    axis: Optional[str]
    rank: int
    size: int

    def index(self, n: int) -> slice:
        """This rank's rows of a leading axis of length `n`."""
        if self.axis is None:
            return slice(None)
        if n % self.size:
            raise ValueError(f"a batch of {n} does not split over "
                             f"{self.size} ranks (pad_batch_to_multiple)")
        k = n // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def batch_sharding(mesh: Mesh) -> Sharding:
    """Leading-axis (batch) sharding over the ranks."""
    return Sharding("data", mesh.rank, mesh.size)


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
    """All-reduce SUM; the backward all-reduces the cotangents."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g)
        return g


def global_sum(x: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """`x` summed over the ranks of `mesh`, else of the active mesh, with
    autograd; `x` itself without a mesh or in a mesh of one."""
    if world_size(mesh) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _SumOverRanks.apply(x)
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y)
    return y


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh] = None
                    ) -> torch.Tensor:
    """Every rank's `x` (the same shape on each) concatenated along the
    leading axis in rank order, on `x`'s device (through the host under
    gloo); no autograd."""
    mesh = mesh or active_mesh()
    if world_size(mesh) == 1:
        return x
    src = x.detach().contiguous()
    if mesh.backend != "nccl":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


def sum_gradients(mesh: Mesh, params) -> None:
    """Sum the `.grad` of `params` over the ranks, in place (one flat
    all-reduce per dtype)."""
    if mesh.size == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    with torch.no_grad():
        _coalesced(grads, dist.all_reduce)


def barrier(mesh: Optional[Mesh]) -> None:
    if world_size(mesh) > 1:
        dist.barrier()


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
