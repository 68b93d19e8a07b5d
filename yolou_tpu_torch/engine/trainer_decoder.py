"""Decoder-stage trainer: YOLO-Seg++'s decoder fine-tuned on a frozen encoder.

Counterpart of `yolou_tpu/engine/trainer_decoder.py`, with the same
semantics: AdamW over the decoder's parameters only, its learning rate on
optax's cosine decay taken per update over `epochs * steps_per_epoch`
updates (a closed-form `LambdaLR`), the soft Dice loss (global over the
batch, soft labels), Dice / HD95 / pooled precision and recall on the
validation split, best and last checkpoints, early stopping with a 1e-3
significance band and a start epoch, a CSV and a PNG of the history, and
resume from the saved step count. The encoder stays bit-identical: it runs
in eval mode without autograd (`YOLOSegPP`), and the optimizer holds none
of its parameters. The decoder's BatchNorms run in training mode with
flax's running-variance rule (`nn/blocks.py::BatchNorm2d`).

An epoch is `step` over the training batches, then `validate` over the
validation batches, both over batches as `DecoderDataset.batches` yields
them; `_loaders` is the one place the datasets come from. The trainer runs
on the GPU unless a CPU device is asked for.

With `mesh` (`parallel/mesh.py`, one trainer in each rank of `launch`) each
rank runs its contiguous shard of every batch. The soft Dice loss stays
global over the batch (its sums and the decoder's BatchNorm statistics
are all-reduced), the decoder's gradients are summed over the ranks, and
the encoder stays bit-identical on every rank; the logged loss and Dice are
the global ones. Validation runs on shards too and gathers the per-image
Dice and HD95 in image order and sums the pixel counts, so every rank holds
the single-process metrics. Rank 0 alone prints and writes files. A mesh
with a model axis is taken as the JAX package takes it here: nothing is
cut, the batch is cut over the data axis and every collective goes over
the data group, so the ranks of a model group repeat each other's work.

Not carried over from the JAX package: `device_data` and
`device_data_budget_mb` (both splits resident on the device and an epoch as
one `lax.scan`, a workaround for a slow host link; the port uploads each
batch) and the asynchronous scalar pipeline of `utils/async_metrics.py`
(the port sums on the device and fetches once an epoch). `best.ckpt` and
`last.ckpt` hold the whole training state in the JAX package's layout
(`utils/train_state.py`): the YOLO-Seg++ variables, the frozen encoder's
among them, AdamW's moments and the update count. Either package resumes the other's file; the encoder in
the file must be the model's own, bit for bit.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import json
import math
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.decoder_dataset import DecoderDataset, prefetch
from ..losses.dice import soft_dice_loss
from ..metrics.seg import dice_binary, hd95_batch, precision_recall_counts
from ..models.segpp import YOLOSegPP
from ..models.yolo import resolve_device
from ..parallel import mesh as meshlib
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.train_state import decoder_state_tree, restore_decoder_state

HISTORY_KEYS = ("train_loss", "val_loss", "train_dice_metric",
                "val_dice_metric", "val_hd95_metric", "val_precision",
                "val_recall")


def plot_history(history: Dict[str, list], save_path: str,
                 filename: str = "plot.png") -> None:
    """Every metric series in one PNG: sorted keys, a colour cycle, legend
    and grid."""
    import itertools
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(save_path, exist_ok=True)
    plt.figure(figsize=(10, 6))
    colours = itertools.cycle(
        ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
         "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"])
    for key in sorted(history.keys()):
        plt.plot(history[key], label=key.replace("_", " ").title(),
                 color=next(colours))
    plt.title("Training History")
    plt.xlabel("Epoch")
    plt.ylabel("Value")
    plt.legend()
    plt.grid(True)
    plt.savefig(os.path.join(save_path, filename))
    plt.close()


@dataclasses.dataclass
class DecoderTrainConfig:
    image_size: int = 160
    batch_size: int = 128
    lr: float = 1e-4
    weight_decay: float = 0.01          # torch AdamW default
    epochs: int = 75
    patience: int = 10
    early_stopping: bool = True
    early_stopping_start: int = 50
    clip_grad_norm: Optional[float] = None   # the reference clips nothing
    seed: int = 42
    shuffle: bool = False               # the reference's fixed order
    run_dir: str = "runs"
    val_hd95: bool = True
    # training conditions the objectmap with a per-image z-score before the
    # sigmoid, evaluation with the raw sigmoid (the reference's quirk);
    # False trains on the raw sigmoid
    normalize_objectmap: bool = True


def cosine_decay(step: int, decay_steps: int) -> float:
    """optax.cosine_decay_schedule's factor at update `step`:
    0.5 (1 + cos(pi min(step, T) / T))."""
    return 0.5 * (1.0 + math.cos(math.pi * min(step, decay_steps)
                                 / decay_steps))


class DecoderTrainer:
    """Trains `model`'s decoder in place. `device=None` means the GPU (an
    error where there is none), or the mesh's device under a `mesh`; the
    model is moved there, and under a mesh given rank 0's weights."""

    def __init__(self, model: YOLOSegPP, data_root: str,
                 cfg: DecoderTrainConfig = DecoderTrainConfig(),
                 device: torch.device | str | None = None,
                 mesh: Optional[meshlib.Mesh] = None):
        if mesh is not None and cfg.batch_size % mesh.n_data:
            raise ValueError(f"batch_size {cfg.batch_size} does not split "
                             f"over {mesh.n_data} ranks of the data axis")
        self.mesh = mesh
        self.is_main = mesh is None or mesh.is_main
        self.device = resolve_device(
            mesh.device if device is None and mesh else device)
        self.model = model.to(self.device)
        if mesh is not None:
            meshlib.replicate(mesh, model)
        self.cfg = cfg
        self.data_root = data_root
        self.history: Dict[str, list] = {k: [] for k in HISTORY_KEYS}
        self.epoch_times: list = []     # wall seconds per train phase (no val)
        self.optimizer: Optional[torch.optim.AdamW] = None
        self.scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
        self.step_count = 0             # optimizer updates applied
        self._decay_steps = 1

    # ------------------------------------------------------------------ setup
    def ensure_ready(self, steps_per_epoch: int = 1) -> None:
        """Build AdamW over the decoder's parameters and its schedule, whose
        length is `epochs * steps_per_epoch` updates; a later call with
        another `steps_per_epoch` changes the length only."""
        self._decay_steps = max(self.cfg.epochs * steps_per_epoch, 1)
        if self.optimizer is None:
            self.optimizer = torch.optim.AdamW(
                list(self.model.decoder_parameters()), lr=self.cfg.lr,
                betas=(0.9, 0.999), eps=1e-8,
                weight_decay=self.cfg.weight_decay)
            self.scheduler = torch.optim.lr_scheduler.LambdaLR(
                self.optimizer,
                lambda t: cosine_decay(t, self._decay_steps))
        self._sync_lr()

    def _sync_lr(self) -> None:
        """The learning rate of the next update from the schedule as it
        stands: after a change of its length, or a restored optimizer state
        that carries the rate of another run."""
        self.scheduler.base_lrs = [self.cfg.lr] * len(
            self.optimizer.param_groups)
        for group in self.optimizer.param_groups:
            group["initial_lr"] = self.cfg.lr
            group["lr"] = self.cfg.lr * cosine_decay(self.step_count,
                                                     self._decay_steps)

    def _upload(self, img, mask, om):
        """NHWC arrays or tensors -> NCHW f32 tensors on the device; uint8
        images and masks are scaled by 1/255 there. Under a mesh, this
        rank's shard of each."""
        if self.mesh is not None:
            img, mask, om = meshlib.shard_batch(self.mesh, (img, mask, om))

        def unit(t):
            t = torch.as_tensor(t).to(self.device, non_blocking=True)
            t = t.float() / 255.0 if t.dtype == torch.uint8 else t.float()
            return t.permute(0, 3, 1, 2)
        return unit(img), unit(mask), unit(om)

    # ------------------------------------------------------------------ steps
    def step(self, img, mask, om):
        """One optimizer update over a batch: img (B, S, S, C), mask (B, S,
        S, 1) (uint8, or f32 in [0, 1]) and the conditioned objectmap om (B,
        S/8, S/8, 1) f32. Returns (loss, Dice of the thresholded prediction
        over the whole batch) as tensors on the device, nothing fetched.
        Under a mesh the batch is the global one, and so are the loss and
        Dice returned."""
        img, mask, om = self._upload(img, mask, om)
        self.model.train()
        with self.mesh or contextlib.nullcontext():
            pred, _ = self.model(img, logits=om)
            loss = soft_dice_loss(pred, mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            meshlib.sum_gradients(self.mesh, self.model.decoder_parameters())
        if self.cfg.clip_grad_norm is not None:
            self._clip_gradients(self.cfg.clip_grad_norm)
        self.optimizer.step()
        self.scheduler.step()
        self.step_count += 1
        with torch.no_grad():
            pred_bin = (torch.sigmoid(pred) > 0.5).float()
            dice = dice_binary(pred_bin[:, 0], mask[:, 0])
            if self.mesh is None:
                return loss.detach(), dice.mean()
            loss, dice = meshlib.global_sum(
                torch.stack([loss.detach(), dice.sum()]), self.mesh)
            return loss, dice / (len(pred) * self.mesh.n_data)

    @torch.no_grad()
    def _clip_gradients(self, max_norm: float) -> None:
        """optax.clip_by_global_norm: scale every gradient by max_norm / norm
        where the global norm is at least max_norm."""
        grads = [p.grad for g in self.optimizer.param_groups
                 for p in g["params"] if p.grad is not None]
        norm = torch.stack(torch._foreach_norm(grads)).norm()
        torch._foreach_mul_(grads, torch.where(
            norm < max_norm, torch.ones_like(norm), max_norm / norm))

    @torch.no_grad()
    def validate(self, batches: Iterable) -> Dict[str, float]:
        """Validation metrics over (imgs, masks, oms, n_real) batches as
        `DecoderDataset.batches` yields them, the last padded to the batch
        size: the padded rows are zeroed out of the global Dice loss and the
        pixel counts, and cut from the per-image Dice and HD95. Precision and
        recall pool the counts over the split. Under a mesh each rank runs
        its shard of each batch; the losses and counts are summed over the
        ranks and the per-image metrics gathered in image order."""
        self.model.eval()
        mesh = self.mesh
        losses, dices, hd95s = [], [], []
        counts = torch.zeros(3, dtype=torch.float64, device=self.device)
        for imgs, masks, oms, n_real in batches:
            img, mask, om = self._upload(imgs, masks, oms)
            first = 0 if mesh is None else mesh.data_index * len(img)
            pred, _ = self.model(img, logits=om)
            row = (torch.arange(first, first + len(img), device=self.device)
                   < n_real).float()[:, None, None]
            probs = torch.sigmoid(pred.float()) * row[:, None]
            with mesh or contextlib.nullcontext():
                losses.append(soft_dice_loss(probs, mask * row[:, None],
                                             sigmoid=False))
            pred_bin = (torch.sigmoid(pred) > 0.5).float()[:, 0]
            m = mask[:, 0]
            if mesh is None:
                dices.append(dice_binary(pred_bin, m)[:n_real])
                if self.cfg.val_hd95:
                    hd95s.append(hd95_batch(pred_bin[:n_real], m[:n_real]))
            else:
                dices.append(meshlib.all_gather_rows(
                    dice_binary(pred_bin, m), mesh)[:n_real])
                if self.cfg.val_hd95:
                    hd95s.append(meshlib.all_gather_rows(
                        hd95_batch(pred_bin, m), mesh)[:n_real])
            counts += torch.stack(precision_recall_counts(
                pred_bin * row, m * row)).double()
        if mesh is not None and losses:
            losses = list(meshlib.global_sum(torch.stack(losses), mesh))
            counts = meshlib.global_sum(counts, mesh)
        tp, fp, fn = counts.tolist()
        hd = (torch.cat(hd95s).cpu().numpy() if hd95s
              else np.asarray([np.nan]))
        return {
            "val_loss": (float(torch.stack(losses).mean()) if losses
                         else 0.0),
            "val_dice_metric": (float(torch.cat(dices).mean()) if dices
                                else 0.0),
            "val_hd95_metric": (float(np.nanmean(hd))
                                if np.any(~np.isnan(hd)) else float("nan")),
            "val_precision": tp / (tp + fp + 1e-6),
            "val_recall": tp / (tp + fn + 1e-6),
        }

    # ------------------------------------------------------------------ loops
    def _loaders(self):
        cfg = self.cfg
        mk = lambda split: DecoderDataset(
            self.data_root, f"images/{split}", f"masks/{split}",
            cfg.image_size, objectmap_path=f"objectmap/{split}",
            normalize_objectmap=cfg.normalize_objectmap)
        return mk("train"), mk("val")

    def train(self, resume_from: Optional[str] = None) -> Dict[str, list]:
        cfg = self.cfg
        train_ds, val_ds = self._loaders()
        steps_per_epoch = max(1, -(-len(train_ds) // cfg.batch_size))
        self.ensure_ready(steps_per_epoch)
        run_dir = os.path.join(cfg.run_dir, time.strftime("%Y_%m_%d_%H_%M_%S"))
        weights_dir = os.path.join(run_dir, "weights")
        if self.is_main:
            os.makedirs(weights_dir, exist_ok=True)
            with open(os.path.join(run_dir, "config.json"), "w") as f:
                json.dump(dataclasses.asdict(cfg), f, indent=2)

        start_epoch = 0
        if resume_from:
            self.load_checkpoint(resume_from)
            # the step counts optimizer updates, not epochs
            start_epoch = self.step_count // steps_per_epoch

        best_val_dice = float("-inf")
        patience = 0
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            # loss and Dice summed on the device, fetched once an epoch; a
            # NaN propagates through the sum
            acc = torch.zeros(2, dtype=torch.float64, device=self.device)
            nb = 0
            for imgs, masks, oms, _ in prefetch(train_ds.batches(
                    cfg.batch_size, shuffle=cfg.shuffle,
                    seed=cfg.seed + epoch, u8=True), depth=3):
                loss, dice = self.step(imgs, masks, oms)
                acc += torch.stack([loss, dice]).double()
                nb += 1
            tr_loss, tr_dice = (acc / max(nb, 1)).tolist()
            if math.isnan(tr_loss):
                if self.is_main:
                    print("NaN loss detected!")
                return self.history
            t1 = time.time()
            self.epoch_times.append(t1 - t0)

            val = self.validate(prefetch(val_ds.batches(cfg.batch_size)))
            va_dice = val["val_dice_metric"]
            t2 = time.time()
            for k, v in (("train_loss", tr_loss),
                         ("train_dice_metric", tr_dice), *val.items()):
                self.history[k].append(v)

            if va_dice > best_val_dice:
                significant = abs(best_val_dice - va_dice) > 1e-3
                best_val_dice = va_dice
                if self.is_main:
                    self._save(os.path.join(weights_dir, "best.ckpt"))
                if significant:
                    patience = 0
                elif epoch + 1 >= cfg.early_stopping_start:
                    patience += 1
            elif epoch + 1 >= cfg.early_stopping_start:
                patience += 1

            if self.is_main:
                self._dump_history(run_dir)
                print(f"epoch {epoch + 1}/{cfg.epochs} "
                      f"train_loss={tr_loss:.4f} "
                      f"val_loss={val['val_loss']:.4f} "
                      f"train_dice={tr_dice:.4f} val_dice={va_dice:.4f} "
                      f"hd95={val['val_hd95_metric']:.3f} "
                      f"p={val['val_precision']:.4f} "
                      f"r={val['val_recall']:.4f} "
                      f"[{t1 - t0:.2f}s train / {t2 - t1:.2f}s val]")

            if cfg.early_stopping and patience >= cfg.patience:
                if self.is_main:
                    print(f"EARLY STOPPING at epoch {epoch + 1} "
                          f"(best val dice {best_val_dice:.4f})")
                break

        if self.is_main:
            self._save(os.path.join(weights_dir, "last.ckpt"))
            try:
                self.plot_history(run_dir)
            except ImportError:             # no matplotlib: no plot
                pass
        meshlib.barrier(self.mesh)
        return self.history

    # ------------------------------------------------------------ checkpoints
    def _save(self, path: str) -> None:
        save_checkpoint(path, decoder_state_tree(self))

    def load_checkpoint(self, path: str) -> None:
        """Restore a training-state `.ckpt`, the port's or the JAX
        trainer's, into this trainer (call `ensure_ready` first;
        `train(resume_from=...)` does)."""
        restore_decoder_state(self, load_checkpoint(path))

    def plot_history(self, save_path: str, filename: str = "plot.png") -> None:
        """The history's curves as one PNG (`plot_history`)."""
        plot_history(self.history, save_path, filename)

    def _dump_history(self, run_dir: str) -> None:
        """history.csv: a column per key in HISTORY_KEYS' order, a row per
        epoch, NaN as an empty field (pandas' `to_csv` form)."""
        with open(os.path.join(run_dir, "history.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            writer.writerow(HISTORY_KEYS)
            for row in zip(*(self.history[k] for k in HISTORY_KEYS)):
                writer.writerow("" if math.isnan(v) else v for v in row)
