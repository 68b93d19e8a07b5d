"""Detector / segmenter fine-tune trainer (the stage-1 YOLO training loop).

Counterpart of `yolou_tpu/engine/trainer_detector.py`: per-step warmup and
cosine schedules of lr and momentum over three parameter groups, gradient
clipping, a skip of non-finite steps, EMA of the parameters, augmentation on
the device with the close-mosaic schedule, the v8 det/seg loss with TAL, and
checkpoints with resume. The model's A2C2f blocks run in training mode, so
each step goes through the hand-written attention kernel
(`kernels.attention.area_attention_fused`) and its backward.

One step, eagerly: augment (no grad) -> forward -> loss -> backward -> clip ->
optimizer -> EMA. Every `val_every` epochs the EMA weights are validated on
the `val` split (`engine/validator.py`, mAP50 and mAP50-95 into `history`)
in a separate eval copy of the model, so the training model's mode,
parameters and BatchNorm statistics stay as they were; `best.ckpt` is
written on each strict rise of ultralytics' fitness 0.1 mAP50 + 0.9
mAP50-95, and `last.ckpt` every epoch. Both hold the whole training state
in the JAX package's layout (`utils/train_state.py`): `load_resume` reads
the port's files and the JAX trainer's, tree form (SGD or AdamW) and flat
form (its default SGD state) alike, so a run resumes across the two
packages. The trainer runs on the GPU unless a CPU device is asked for.

With `mesh` (`parallel/mesh.py`, one trainer in each rank of `launch`) a
step is one process's step over the same global batch: every rank uploads
and augments the whole batch with the same generator state (mosaic, mixup
and cutmix mix its images), then runs forward, loss and backward on its
contiguous shard with BatchNorm's statistics and the loss's normalizers
taken over the global batch; the gradients are summed over the ranks, so
clipping, the non-finite skip, the optimizer and the EMA are the same on
every rank. Rank 0 alone validates, prints and writes files; the others
wait at a barrier. The augmentation is done N times over, once a rank.

With a mesh that has a model axis and `sharding` (the rules of
`parallel/mesh.py::param_sharding_rules`), the model is cut after rank 0's
weights are copied and before the optimizer is built, so the momentum or
Adam moments and the EMA of a cut weight are slices too. The ranks of a
model group take the same batch shard; the gradients are summed over the
data group, then each replicated parameter's gradient is averaged over the
model group (exact where the copies agree, and it stops a drift where a
nondeterministic backward makes them differ in the last bit). The global
gradient norm adds the cut gradients' squares over the model group and
counts the replicated ones once. Validation and the files see the whole
weights, gathered over the model group by every rank: every rank validates
(rank 0's metrics decide) and rank 0 writes. A whole state read back is
cut again, so a file resumes under any mesh.

Not carried over from the JAX package: the packed single-buffer upload, the
device-resident dataset with its whole-epoch scan and the flat-vector
optimizer (three workarounds for a slow host link and per-leaf dispatch
costs; a flat-form file is read, the tree form written).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.augment import AugHyp, augment_batch
from ..data.yolo_dataset import YoloSegDataset, collate_idmap_cached
from ..losses.v8 import LossHyp, v8_loss
from ..models.yolo import YOLOModel, resolve_device
from ..parallel import mesh as meshlib
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.train_state import detector_state_tree, restore_detector_state

LOSS_KEYS = ("loss", "box", "cls", "dfl", "seg")
MAX_CONSECUTIVE_NONFINITE = 100


@dataclasses.dataclass
class DetectorTrainConfig:
    imgsz: int = 160
    batch_size: int = 16
    epochs: int = 10
    lr0: float = 0.01
    lrf: float = 0.01               # final lr fraction (cosine)
    momentum: float = 0.937
    weight_decay: float = 5e-4
    warmup_epochs: float = 3.0
    warmup_momentum: float = 0.8
    warmup_bias_lr: float = 0.1
    ema_decay: float = 0.9999
    ema_tau: float = 2000.0
    clip_grad_norm: float = 10.0    # ultralytics BaseTrainer clips at 10.0
    skip_nonfinite: bool = True     # skip the update when grads are inf/nan
    close_mosaic: int = 10          # disable mosaic for the last N epochs
    max_instances: int = 16
    mask_ratio: int = 4
    seed: int = 0
    run_dir: str = "runs_detector"
    optimizer: str = "sgd"          # "sgd" (ultralytics auto default) | "adamw"
    val_every: int = 0              # validate the EMA weights every N epochs (0: never)


Schedule = Callable[[int], float]


def detector_schedules(cfg: DetectorTrainConfig, steps_per_epoch: int
                       ) -> Tuple[Schedule, Schedule, Schedule]:
    """(lr_main, lr_bias, momentum) as functions of the optimizer's step
    count: linear warmup over `warmup_epochs` (lr from 0, the bias group's
    from `warmup_bias_lr`, momentum from `warmup_momentum`), then cosine
    decay of lr to lr0 * lrf."""
    total = max(1, cfg.epochs * steps_per_epoch)
    warm = int(cfg.warmup_epochs * steps_per_epoch)

    def cosine(step: int) -> float:
        prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
        return cfg.lr0 * (cfg.lrf + (1 - cfg.lrf) * 0.5
                          * (1 + math.cos(math.pi * prog)))

    def frac(step: int) -> float:
        return min(max(step / max(warm, 1), 0.0), 1.0)

    def lr_fn(step: int, start: float) -> float:
        if step < warm:
            return start + (cosine(step) - start) * frac(step)
        return cosine(step)

    def mom_fn(step: int) -> float:
        if step < warm:
            return (cfg.warmup_momentum
                    + (cfg.momentum - cfg.warmup_momentum) * frac(step))
        return cfg.momentum

    return (lambda step: lr_fn(step, 0.0),
            lambda step: lr_fn(step, cfg.warmup_bias_lr), mom_fn)


def parameter_groups(model: nn.Module) -> Dict[str, List[nn.Parameter]]:
    """The trainable parameters in ultralytics' three groups: "bias" (every
    bias: no decay, own warmup), "nodecay" (BatchNorm weights) and "decay"
    (the rest). Frozen parameters (the head's fixed DFL projection) are in
    none."""
    groups: Dict[str, List[nn.Parameter]] = {"bias": [], "nodecay": [],
                                             "decay": []}
    for m in model.modules():
        for name, p in m.named_parameters(recurse=False):
            if not p.requires_grad:
                continue
            if name == "bias":
                groups["bias"].append(p)
            elif isinstance(m, nn.modules.batchnorm._BatchNorm):
                groups["nodecay"].append(p)
            else:
                groups["decay"].append(p)
    return groups


def make_detector_tx(model: nn.Module, cfg: DetectorTrainConfig,
                     steps_per_epoch: int):
    """ultralytics `build_optimizer` + warmup: the optimizer over the three
    groups of `parameter_groups` (weight decay on "decay" only) and the
    schedules of `detector_schedules`. The caller sets each group's lr (and,
    for SGD, momentum) from the schedules before every `step()`. Returns
    (optimizer, lr_main, lr_bias, mom_fn)."""
    lr_main, lr_bias, mom_fn = detector_schedules(cfg, steps_per_epoch)
    groups = parameter_groups(model)
    param_groups = [
        {"params": groups["bias"], "name": "bias", "weight_decay": 0.0},
        {"params": groups["nodecay"], "name": "nodecay", "weight_decay": 0.0},
        {"params": groups["decay"], "name": "decay",
         "weight_decay": cfg.weight_decay}]
    if cfg.optimizer == "adamw":
        # ultralytics AdamW path: betas = (momentum, 0.999), no momentum ramp
        opt = torch.optim.AdamW(param_groups, lr=cfg.lr0,
                                betas=(cfg.momentum, 0.999), eps=1e-8)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(param_groups, lr=cfg.lr0,
                              momentum=cfg.warmup_momentum, dampening=0.0,
                              nesterov=True)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return opt, lr_main, lr_bias, mom_fn


def epoch_index_batches(idx: np.ndarray, batch_size: int):
    """Split a permutation into fixed-size batches, wrap-filling the tail
    from the same permutation instead of dropping it: every image is seen
    each epoch, a few twice in the last step."""
    for s in range(0, len(idx), batch_size):
        sel = idx[s:s + batch_size]
        if len(sel) < batch_size:
            sel = np.concatenate([sel, np.resize(idx, batch_size - len(sel))])
        yield sel


class DetectorTrainer:
    """Trains `model` in place. `device=None` means the GPU (an error where
    there is none), or the mesh's device under a `mesh`; the model is moved
    there, and under a mesh given rank 0's weights."""

    def __init__(self, model: YOLOModel, data_cfg,
                 cfg: DetectorTrainConfig = DetectorTrainConfig(),
                 aug: AugHyp = AugHyp(), loss_hyp: LossHyp = LossHyp(),
                 device: torch.device | str | None = None,
                 mesh: Optional[meshlib.Mesh] = None,
                 sharding: Optional[Dict[str, meshlib.Sharding]] = None):
        if mesh is not None and cfg.batch_size % mesh.n_data:
            raise ValueError(f"batch_size {cfg.batch_size} does not split "
                             f"over {mesh.n_data} ranks of the data axis")
        if sharding is not None and mesh is None:
            raise ValueError("sharding rules without a mesh")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = resolve_device(
            mesh.device if device is None and mesh else device)
        self.model = model.to(self.device)
        if mesh is not None:
            meshlib.replicate(mesh, model)
        if sharding is not None:
            meshlib.shard_module(mesh, model, sharding)
        # under a model axis: whether each trainable parameter is cut
        self.cut = [n in meshlib.model_shards(model)
                    for n, p in model.named_parameters() if p.requires_grad]
        self.sharded = any(self.cut)
        self.cfg, self.aug, self.loss_hyp = cfg, aug, loss_hyp
        self.data_cfg = data_cfg
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.ema_params: Optional[List[torch.Tensor]] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step_count = 0          # steps taken, skipped ones included
        self.opt_count = 0           # optimizer updates applied
        self._notfinite = 0          # consecutive non-finite steps
        self.total_notfinite = 0     # non-finite steps in all
        self.last_finite = True      # whether the last step's were finite
        # global gradient norm of the last step before clipping, on the device
        self.grad_norm: Optional[torch.Tensor] = None
        self._spe: Optional[int] = None
        self.history: Dict[str, list] = {k: [] for k in LOSS_KEYS + ("lr",)}
        self.epoch_times: list = []  # wall seconds per train epoch
        self.val_times: list = []    # wall seconds per validation
        self._val_model: Optional[YOLOModel] = None

    # ------------------------------------------------------------------ setup
    def ensure_ready(self, steps_per_epoch: int) -> None:
        """Build the optimizer, the schedules and the EMA copy; on a later
        call with another `steps_per_epoch`, the schedules only."""
        if self.optimizer is None:
            (self.optimizer, self._lr_fn, self._lr_bias_fn,
             self._mom_fn) = make_detector_tx(self.model, self.cfg,
                                              steps_per_epoch)
            self.ema_params = [p.detach().clone() for p in self.params]
        elif steps_per_epoch != self._spe:
            self._lr_fn, self._lr_bias_fn, self._mom_fn = detector_schedules(
                self.cfg, steps_per_epoch)
        self._spe = steps_per_epoch

    def _set_hyperparams(self) -> None:
        n = self.opt_count
        for group in self.optimizer.param_groups:
            bias = group["name"] == "bias"
            group["lr"] = self._lr_bias_fn(n) if bias else self._lr_fn(n)
            if "momentum" in group:
                group["momentum"] = self._mom_fn(n)

    # ------------------------------------------------------------------ step
    def step(self, batch, generator: torch.Generator, use_mosaic: bool):
        """One training step over `batch` = (img uint8 (B, S, S, C), idmap
        (B, S, S) int, cls (B, G) int, valid (B, G) bool), tensors or numpy
        arrays, in `collate_idmap_cached`'s form. `generator` (on the
        trainer's device) drives the augmentation. Returns (loss, parts) as
        tensors on the device; nothing is fetched to the host except the one
        flag that says whether the gradients were finite. Under a mesh
        `batch` is the global batch, and the loss and parts returned are
        the global ones."""
        aug = self.augment(batch, generator, use_mosaic)
        if self.mesh is not None:
            rows = meshlib.batch_sharding(self.mesh).index(len(aug["img"]))
            aug = {k: v[rows] for k, v in aug.items()}
        self.model.train()
        with self.mesh or contextlib.nullcontext():
            lo = self.loss(self.model(aug["img"].permute(0, 3, 1, 2)), aug)
        self.optimizer.zero_grad(set_to_none=True)
        lo.total.backward()
        if self.mesh is not None:
            meshlib.sum_gradients(self.mesh, self.params)
            meshlib.mean_over_model(self.mesh, [
                p for p, cut in zip(self.params, self.cut) if not cut])
        self.apply_gradients()
        self.update_ema()
        total = lo.total.detach()
        parts = {k: v.detach() for k, v in lo.parts.items()}
        if self.mesh is not None:
            names = list(parts)
            summed = meshlib.global_sum(
                torch.stack([total] + [parts[k] for k in names]), self.mesh)
            total, parts = summed[0], dict(zip(names, summed[1:]))
        return total, parts

    @torch.no_grad()
    def augment(self, batch, generator: torch.Generator,
                use_mosaic: bool) -> Dict[str, torch.Tensor]:
        """Upload `batch` and run the augmentation pipeline: the loss batch
        (img (B, S, S, C) float32, cls, bboxes, valid, masks)."""
        img_u8, idmap, cls, valid = (
            torch.as_tensor(t).to(self.device, non_blocking=True)
            for t in batch)
        return augment_batch(img_u8.float() / 255.0, idmap, cls, valid,
                             generator, self.aug,
                             g_out=self.cfg.max_instances,
                             mask_ratio=self.cfg.mask_ratio,
                             use_mosaic=use_mosaic)

    def loss(self, out, aug: Dict[str, torch.Tensor]):
        """The v8 loss of the model's outputs against an augmented batch."""
        spec = self.model.spec
        return v8_loss(out.raw, out.mask_coefs, out.protos, aug, nc=spec.nc,
                       strides=spec.strides, reg_max=spec.reg_max,
                       hyp=self.loss_hyp, with_masks=spec.task == "segment")

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Clip at the global norm, then the optimizer's update, unless a
        gradient is non-finite: such a step is skipped (parameters,
        optimizer state and schedule clock stay), but once more than
        MAX_CONSECUTIVE_NONFINITE steps in a row were non-finite the update
        is applied anyway, so a run that is broken for good fails visibly.
        Under a model axis the norm is the whole model's: the squares of the
        cut gradients summed over the model group, the replicated ones
        counted once."""
        cfg = self.cfg
        grads = [p.grad for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads))
        if self.sharded:
            sq = norms.square()
            cut = torch.tensor(self.cut, device=sq.device)
            self.grad_norm = (meshlib.sum_over_model(self.mesh, sq[cut].sum())
                              + sq[~cut].sum()).sqrt()
        else:
            self.grad_norm = norms.norm()
        if cfg.skip_nonfinite:
            self.last_finite = bool(torch.isfinite(
                self.grad_norm if self.sharded else norms).all())
            if self.last_finite:
                self._notfinite = 0
            else:
                self._notfinite += 1
                self.total_notfinite += 1
                if self._notfinite <= MAX_CONSECUTIVE_NONFINITE:
                    return
        if cfg.clip_grad_norm:
            coef = torch.where(self.grad_norm < cfg.clip_grad_norm,
                               torch.ones_like(self.grad_norm),
                               cfg.clip_grad_norm / self.grad_norm)
            torch._foreach_mul_(grads, coef)
        self._set_hyperparams()
        self.optimizer.step()
        self.opt_count += 1

    @torch.no_grad()
    def update_ema(self) -> None:
        """Count the step and fold the parameters into the EMA with
        ultralytics' ramping decay d = d0 (1 - exp(-step / tau)); skipped
        steps count too."""
        self.step_count += 1
        d = self.cfg.ema_decay * (
            1 - math.exp(-self.step_count / self.cfg.ema_tau))
        torch._foreach_mul_(self.ema_params, d)
        torch._foreach_add_(self.ema_params, self.params, alpha=1 - d)

    def notfinite_count(self) -> int:
        """Consecutive non-finite (skipped) optimizer steps; 0 when healthy."""
        return self._notfinite

    # ------------------------------------------------------------- validation
    def validate(self, val_ds) -> Dict[str, float]:
        """`validate_detector` of the EMA weights (with the model's
        BatchNorm statistics) over `val_ds`, in an eval copy of the model
        with whole weights made at the first call: the training model is
        not touched. Under a model axis every rank calls it (the EMA
        weights are gathered)."""
        from .validator import validate_detector
        if self._val_model is None:
            self._val_model = meshlib.whole_copy(self.model).requires_grad_(
                False).eval()
            for p in self._val_model.parameters():
                p.grad = None
        cfg = self.cfg
        return validate_detector(
            self._val_model, self.ema_variables(), val_ds, imgsz=cfg.imgsz,
            channels=self.data_cfg.channels, batch_size=cfg.batch_size,
            max_inst=cfg.max_instances)

    # ------------------------------------------------------------------ train
    def _datasets(self):
        """(train, val) datasets; val is None when `val_every` is 0. The one
        place the trainer's data comes from: a caller may put datasets held
        in memory here (objects with `YoloSegDataset`'s methods)."""
        mk = lambda split: YoloSegDataset(
            self.data_cfg.split_dir(split), imgsz=self.cfg.imgsz,
            channels=self.data_cfg.channels, cache_images=True)
        return mk("train"), mk("val") if self.cfg.val_every else None

    def train(self, resume_from: Optional[str] = None) -> Dict[str, list]:
        cfg = self.cfg
        ds, val_ds = self._datasets()
        # ceil: the wrap-filled remainder batch is a real step
        steps_per_epoch = max(
            1, (len(ds) + cfg.batch_size - 1) // cfg.batch_size)
        self.ensure_ready(steps_per_epoch)

        run_dir = os.path.join(cfg.run_dir, time.strftime("%Y_%m_%d_%H_%M_%S"))
        weights = os.path.join(run_dir, "weights")
        if self.is_main:
            os.makedirs(weights, exist_ok=True)
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)

        start_epoch = 0
        if resume_from:
            self.load_resume(resume_from)
            start_epoch = self.step_count // steps_per_epoch

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        best_fitness = float("-inf")
        for epoch in range(start_epoch, cfg.epochs):
            mosaic_on = epoch < cfg.epochs - cfg.close_mosaic
            t0 = time.time()
            acc = torch.zeros(len(LOSS_KEYS), device=self.device)
            nb = 0
            idx = np.random.default_rng(cfg.seed + epoch).permutation(len(ds))
            for sel in epoch_index_batches(idx, cfg.batch_size):
                cb = collate_idmap_cached(ds, sel, cfg.max_instances)
                loss, parts = self.step(
                    (cb["img"], cb["idmap"], cb["cls"], cb["valid"]), gen,
                    mosaic_on)
                # summed on the device; fetched once per epoch
                acc += torch.stack([loss.float()] + [
                    parts[k].float() for k in LOSS_KEYS[1:]])
                nb += 1
            mean = (acc / max(nb, 1)).tolist()
            self.epoch_times.append(time.time() - t0)
            for k, v in zip(LOSS_KEYS, mean):
                self.history[k].append(v)
            self.history["lr"].append(self._lr_fn(self.opt_count))
            msg = (f"epoch {epoch + 1}/{cfg.epochs} "
                   + " ".join(f"{k}={v:.4f}" for k, v in zip(LOSS_KEYS, mean))
                   + f" [{time.time() - t0:.1f}s, mosaic={mosaic_on}]")
            if self._notfinite:
                msg += (f" | WARN: {self._notfinite} consecutive non-finite "
                        f"steps skipped")
            # under a model axis the whole weights are gathered by every
            # rank: every rank validates and calls save_checkpoint
            active = self.is_main or self.sharded
            if (cfg.val_every and (epoch + 1) % cfg.val_every == 0
                    and active):
                t1 = time.time()
                vm = self.validate(val_ds)
                if self.sharded:          # rank 0's metrics decide
                    vm = meshlib.from_main(self.mesh, vm)
                self.val_times.append(time.time() - t1)
                self.history.setdefault("map50", []).append(vm["map50"])
                self.history.setdefault("map", []).append(vm["map"])
                msg += (f" | val mAP50={vm['map50']:.4f} "
                        f"mAP50-95={vm['map']:.4f}")
                # ultralytics fitness; best.ckpt on a strict rise
                fitness = 0.1 * vm["map50"] + 0.9 * vm["map"]
                if fitness > best_fitness:
                    best_fitness = fitness
                    self.save_checkpoint(os.path.join(weights, "best.ckpt"))
            if self.is_main:
                print(msg)
            if active:
                self.save_checkpoint(os.path.join(weights, "last.ckpt"))
            meshlib.barrier(self.mesh)
        return self.history

    # ------------------------------------------------------------ checkpoints
    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """A state_dict of the model with the EMA parameters in place of the
        trained ones (buffers, BatchNorm's running statistics among them,
        are the model's own), every tensor whole: under a model axis the
        cut ones are gathered, a collective of every rank."""
        sd = {k: v.clone() for k, v in
              meshlib.gathered_state(self.mesh, self.model).items()}
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        ema = meshlib.gathered_state(self.mesh, self.model,
                                     dict(zip(names, self.ema_params)))
        for name, e in ema.items():
            sd[name] = e.clone()
        return sd

    def save_checkpoint(self, path: str) -> None:
        """Write the whole training state to `path` as the JAX trainer's
        tree form (`utils/train_state.py`), which both packages resume.
        Under a model axis every rank calls it (the cut weights are
        gathered) and rank 0 writes; no file holds a slice."""
        state = detector_state_tree(self)
        if self.is_main:
            save_checkpoint(path, state)

    def load_resume(self, path: str) -> None:
        """Restore a training-state `.ckpt` into this trainer (call
        `ensure_ready` first; `train(resume_from=...)` does): the port's,
        or the JAX trainer's tree or flat form. A flat-form file gives the
        same momentum as its tree form, so the run goes on exactly; a file
        of another optimizer raises. Under a model axis every rank reads
        the whole state and keeps its slices."""
        restore_detector_state(self, load_checkpoint(path))
