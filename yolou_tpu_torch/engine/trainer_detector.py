"""Detector / segmenter fine-tune trainer (the stage-1 YOLO training loop).

Counterpart of `yolou_tpu/engine/trainer_detector.py`: per-step warmup and
cosine schedules of lr and momentum over three parameter groups, gradient
clipping, a skip of non-finite steps, EMA of the parameters, augmentation on
the device with the close-mosaic schedule, the v8 det/seg loss with TAL, and
checkpoints with resume. The model's A2C2f blocks run in training mode, so
each step goes through the hand-written attention kernel
(`kernels.attention.area_attention_fused`) and its backward.

One step, eagerly: augment (no grad) -> forward -> loss -> backward -> clip ->
optimizer -> EMA. The trainer runs on the GPU unless a CPU device is asked
for. Not carried over from the JAX package: the packed single-buffer upload,
the device-resident dataset with its whole-epoch scan and the flat-vector
optimizer (three workarounds for a slow host link and per-leaf dispatch
costs), and data-parallel meshes.

Not ported yet: validation during training. `val_every > 0` raises until the
validator is; `best.pt`, which is chosen by validation fitness, is therefore
not written, only `last.pt`. Checkpoints are `torch.save` files, not the JAX
package's `.ckpt` format.
"""

from __future__ import annotations

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
    val_every: int = 0              # validation every N epochs: not ported, must be 0


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
    there is none); the model is moved there."""

    def __init__(self, model: YOLOModel, data_cfg,
                 cfg: DetectorTrainConfig = DetectorTrainConfig(),
                 aug: AugHyp = AugHyp(), loss_hyp: LossHyp = LossHyp(),
                 device: torch.device | str | None = None):
        if cfg.val_every:
            raise NotImplementedError(
                "val_every > 0 needs the detector validator, which is not "
                "ported yet")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.cfg, self.aug, self.loss_hyp = cfg, aug, loss_hyp
        self.data_cfg = data_cfg
        self.params = [p for p in model.parameters() if p.requires_grad]
        self.ema_params: Optional[List[torch.Tensor]] = None
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.step_count = 0          # steps taken, skipped ones included
        self.opt_count = 0           # optimizer updates applied
        self._notfinite = 0
        # global gradient norm of the last step before clipping, on the device
        self.grad_norm: Optional[torch.Tensor] = None
        self._spe: Optional[int] = None
        self.history: Dict[str, list] = {k: [] for k in LOSS_KEYS + ("lr",)}
        self.epoch_times: list = []  # wall seconds per train epoch

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
        flag that says whether the gradients were finite."""
        aug = self.augment(batch, generator, use_mosaic)
        self.model.train()
        lo = self.loss(self.model(aug["img"].permute(0, 3, 1, 2)), aug)
        self.optimizer.zero_grad(set_to_none=True)
        lo.total.backward()
        self.apply_gradients()
        self.update_ema()
        return lo.total.detach(), {k: v.detach() for k, v in lo.parts.items()}

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
        is applied anyway, so a run that is broken for good fails visibly."""
        cfg = self.cfg
        grads = [p.grad for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads))
        self.grad_norm = norms.norm()
        if cfg.skip_nonfinite:
            if bool(torch.isfinite(norms).all()):
                self._notfinite = 0
            else:
                self._notfinite += 1
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

    # ------------------------------------------------------------------ train
    def train(self, resume_from: Optional[str] = None) -> Dict[str, list]:
        cfg = self.cfg
        ds = YoloSegDataset(self.data_cfg.split_dir("train"), imgsz=cfg.imgsz,
                            channels=self.data_cfg.channels,
                            cache_images=True)
        # ceil: the wrap-filled remainder batch is a real step
        steps_per_epoch = max(
            1, (len(ds) + cfg.batch_size - 1) // cfg.batch_size)
        self.ensure_ready(steps_per_epoch)

        run_dir = os.path.join(cfg.run_dir, time.strftime("%Y_%m_%d_%H_%M_%S"))
        weights = os.path.join(run_dir, "weights")
        os.makedirs(weights, exist_ok=True)
        with open(os.path.join(run_dir, "config.json"), "w") as f:
            json.dump(dataclasses.asdict(cfg), f, indent=2)

        start_epoch = 0
        if resume_from:
            self.load_resume(resume_from)
            start_epoch = self.step_count // steps_per_epoch

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
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
            print(msg)
            self.save_checkpoint(os.path.join(weights, "last.pt"))
        return self.history

    # ------------------------------------------------------------ checkpoints
    def ema_variables(self) -> Dict[str, torch.Tensor]:
        """A state_dict of the model with the EMA parameters in place of the
        trained ones (buffers, BatchNorm's running statistics among them,
        are the model's own)."""
        sd = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        names = [n for n, p in self.model.named_parameters() if p.requires_grad]
        for name, e in zip(names, self.ema_params):
            sd[name] = e.clone()
        return sd

    def save_checkpoint(self, path: str) -> None:
        torch.save({"model": self.model.state_dict(),
                    "ema_params": self.ema_params,
                    "optimizer": self.optimizer.state_dict(),
                    "step": self.step_count, "opt_count": self.opt_count,
                    "notfinite": self._notfinite}, path)

    def load_resume(self, path: str) -> None:
        """Restore a `save_checkpoint` file into this trainer (call
        `ensure_ready` first; `train(resume_from=...)` does)."""
        ck = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(ck["model"], strict=True)
        self.optimizer.load_state_dict(ck["optimizer"])
        with torch.no_grad():
            for e, saved in zip(self.ema_params, ck["ema_params"]):
                e.copy_(saved)
        self.step_count, self.opt_count = ck["step"], ck["opt_count"]
        self._notfinite = ck["notfinite"]
