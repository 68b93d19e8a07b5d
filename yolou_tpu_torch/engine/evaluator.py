"""End-to-end evaluator: fused YOLO + decoder forward -> Dice / HD95 / P / R.

Counterpart of `yolou_tpu/engine/evaluator.py`: batched, one backbone pass
for the detector's outputs and the decoder's mask, and NMS still called on
the detector's predictions (its output feeds the Results path). The
conditioning is the fused pass's: sigmoid of the raw class-logit map with no
z-score. Metrics run on the model's device; one host transfer at the end.

With `mesh` (`parallel/mesh.py`, one evaluator in each rank of `launch`)
each rank runs its contiguous shard of every batch (a batch that does not
split is padded first, `pad_batch_to_multiple`); the per-image Dice and
HD95 are gathered in image order and cut at the batch's real rows, and the
pixel counts are summed over the ranks, so every rank returns the
single-process metrics. Under a model axis the batch is cut over the data
axis and the collectives go over the data group; nothing is cut.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..data.decoder_dataset import DecoderDataset, prefetch
from ..metrics.seg import dice_binary, hd95_batch, precision_recall_counts
from ..models.segpp import YOLOSegPP
from ..models.yolo import resolve_device
from ..ops.nms import NMSResult, non_max_suppression
from ..parallel import mesh as meshlib


class Evaluator:
    def __init__(self, model: YOLOSegPP, data_root: str,
                 image_size: int = 160, batch_size: int = 16,
                 conf: float = 0.25, iou: float = 0.45, max_det: int = 300,
                 device: torch.device | str | None = None,
                 mesh: Optional[meshlib.Mesh] = None):
        """`device` None means the GPU (an error where there is none; pass
        "cpu" to ask for the CPU), or the mesh's device under a `mesh`; the
        model is moved there, and under a mesh given rank 0's weights."""
        self.mesh = mesh
        self.device = resolve_device(
            mesh.device if device is None and mesh else device)
        self.model = model.to(self.device).eval()
        if mesh is not None:
            meshlib.replicate(mesh, self.model)
        self.data_root = data_root
        self.image_size = image_size
        self.batch_size = batch_size
        self.conf, self.iou, self.max_det = conf, iou, max_det

    @torch.no_grad()
    def step(self, imgs) -> Tuple[torch.Tensor, NMSResult]:
        """(B, H, W, C) float images in [0, 1] (array or tensor) ->
        (pred_bin (B, H, W, 1) f32 in {0, 1}, detections), on the device."""
        x = torch.as_tensor(imgs).to(self.device)
        mask_logits, out = self.model(x.permute(0, 3, 1, 2))
        dets = non_max_suppression(out.preds, conf_thres=self.conf,
                                   iou_thres=self.iou, max_det=self.max_det,
                                   nc=self.model.spec.nc)
        pred_bin = (torch.sigmoid(mask_logits) > 0.5).float()
        return pred_bin.permute(0, 2, 3, 1), dets

    def accumulate(self, batches: Iterable, with_hd95: bool = True
                   ) -> Dict[str, float]:
        """Metrics over an iterator of (imgs, masks, _, n_real) batches as
        `DecoderDataset.batches` yields them (NHWC float arrays; the last
        batch padded to the batch size, `n_real` of its rows real)."""
        mesh = self.mesh
        dices, hd95s = [], []
        totals = torch.zeros(3, dtype=torch.float64, device=self.device)
        n_images = 0
        t0 = time.time()
        for imgs, masks, _, n_real in batches:
            if mesh is None:
                pred = self.step(imgs)[0][:n_real, ..., 0]
                m = torch.as_tensor(masks[:n_real]).to(self.device)[..., 0]
                dices.append(dice_binary(pred, m))
                totals += torch.stack(
                    precision_recall_counts(pred, m)).double()
                if with_hd95:
                    hd95s.append(hd95_batch(pred, m))
            else:
                (imgs, masks), _ = meshlib.pad_batch_to_multiple(
                    (imgs, masks), mesh.n_data)
                imgs, masks = meshlib.shard_batch(mesh, (imgs, masks))
                pred = self.step(imgs)[0][..., 0]
                m = masks[..., 0]
                first = mesh.data_index * len(pred)
                real = (torch.arange(first, first + len(pred),
                                     device=self.device) < n_real)
                dices.append(meshlib.all_gather_rows(
                    dice_binary(pred, m), mesh)[:n_real])
                totals += torch.stack(precision_recall_counts(
                    pred[real], m[real])).double()
                if with_hd95:
                    hd95s.append(meshlib.all_gather_rows(
                        hd95_batch(pred, m), mesh)[:n_real])
            n_images += n_real
        if mesh is not None:
            totals = meshlib.global_sum(totals, mesh)
        tp, fp, fn = totals.tolist()          # waits for the device
        dt = time.time() - t0
        dice = (float(torch.cat(dices).mean()) if dices else float("nan"))
        hd_all = (torch.cat(hd95s).cpu().numpy() if hd95s
                  else np.asarray([np.nan]))
        hd95 = (float(np.nanmean(hd_all))
                if np.any(~np.isnan(hd_all)) else float("nan"))
        return {
            "dice": dice,
            "hd95": hd95,
            "precision": tp / (tp + fp + 1e-6),
            "recall": tp / (tp + fn + 1e-6),
            "images_per_sec": n_images / max(dt, 1e-9),
            "n_images": n_images,
        }

    def evaluate(self, split: str = "test",
                 with_hd95: bool = True) -> Dict[str, float]:
        ds = DecoderDataset(self.data_root, f"images/{split}",
                            f"masks/{split}", self.image_size)
        return self.accumulate(prefetch(ds.batches(self.batch_size)),
                               with_hd95)
