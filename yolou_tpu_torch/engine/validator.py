"""Detector validator: mAP50 / mAP50-95 / precision / recall over a split.

Counterpart of `yolou_tpu/engine/validator.py::validate_detector`, with the
same arguments and defaults. A batch goes to the model's device in one
upload; the forward runs in eval mode (kernel A eight times on a YOLOv12n
model), then `ops/nms.py::non_max_suppression` (kernel B once), and the
detections come back in one device-to-host copy. Box matching and average
precision run on the host in numpy (`metrics/det.py`). The three parts
(`validation_batches`, `detect_batch`, `score_batch`) are public so that a
timer can measure each of them on the path that ships.

`rect=True` is ultralytics' rect-mode validation: images grouped by aspect
ratio, each group letterboxed to a shared stride-aligned shape instead of
square-stretched. The tail batch is padded with its first item; the padding
is not scored.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..data.yolo_dataset import (YoloSegDataset, collate_padded,
                                 rect_batch_shape, rect_groups)
from ..metrics.det import DetMetrics
from ..models.yolo import YOLOModel
from ..ops.nms import non_max_suppression


def _xywh2xyxy(b: np.ndarray) -> np.ndarray:
    cx, cy, w, h = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


@torch.no_grad()
def detect_batch(model: YOLOModel, imgs_u8: np.ndarray, *, conf: float,
                 iou: float, max_det: int,
                 mark: Optional[Callable[[], None]] = None) -> np.ndarray:
    """One validation batch on the model's device: uint8 (B, H, W, C) ->
    (B, max_det, 7) float32 on the host, each row (x1, y1, x2, y2, conf,
    cls, valid). `mark`, where given, is called after each part (upload,
    forward, NMS, the copy back), as a timer's hook."""
    mark = mark or (lambda: None)
    device = next(model.parameters()).device
    x = torch.as_tensor(imgs_u8).to(device, non_blocking=True)
    mark()
    out = model(x.permute(0, 3, 1, 2).float() / 255.0)
    mark()
    dets = non_max_suppression(out.preds, conf_thres=conf, iou_thres=iou,
                               max_det=max_det, nc=model.spec.nc)
    mark()
    packed = torch.cat([dets.boxes.float(), dets.conf.float()[..., None],
                        dets.cls.float()[..., None],
                        dets.valid.float()[..., None]], -1).cpu()
    mark()
    return packed.numpy()


def validation_batches(data, *, imgsz: int, batch_size: int, max_inst: int,
                       rect: bool, stride: int
                       ) -> Iterator[Tuple[int, Tuple[int, int], Dict]]:
    """The host's half of each batch: (images scored, (H, W), the collated
    batch), the tail padded with its first item."""
    n = len(data)
    if rect:
        shapes = [data.orig_shape(i) for i in range(n)]
        groups = rect_groups(shapes, batch_size)
    else:
        groups = [list(range(s, min(s + batch_size, n)))
                  for s in range(0, n, batch_size)]
    for idxs in groups:
        if rect:
            hw = rect_batch_shape([shapes[i] for i in idxs], imgsz, stride)
            items = [data.item_rect(i, hw) for i in idxs]
        else:
            hw = (imgsz, imgsz)
            items = [data.item(i) for i in idxs]
        while len(items) < batch_size:
            items.append(items[0])
        yield len(idxs), hw, collate_padded(items, max_inst)


def score_batch(metrics: DetMetrics, dets: np.ndarray, batch: Dict, n: int,
                hw: Tuple[int, int]) -> None:
    """Match the first `n` images' detections to their labels into
    `metrics`."""
    scale = np.array([hw[1], hw[0], hw[1], hw[0]], np.float32)
    for bi in range(n):
        d = dets[bi]
        k = int(d[:, 6].sum())
        gt_valid = batch["valid"][bi]
        gt_xyxy = _xywh2xyxy(batch["bboxes"][bi][gt_valid]) * scale
        metrics.update(d[:k, :4], d[:k, 4], d[:k, 5], gt_xyxy,
                       batch["cls"][bi][gt_valid])


def validate_detector(model: YOLOModel,
                      variables: Optional[Dict[str, torch.Tensor]], data, *,
                      imgsz: int = 160, channels: int = 4,
                      batch_size: int = 16, conf: float = 0.001,
                      iou: float = 0.45, max_det: int = 300,
                      max_inst: int = 16, rect: bool = False,
                      stride: int = 32) -> Dict[str, float]:
    """Precision, recall, mAP50 and mAP50-95 of `model` over `data`.

    `variables` is a state_dict loaded into `model` first (strictly), or None
    to use its weights as they are; the weights stay loaded. `data` is an
    image directory (read by `YoloSegDataset`) or a dataset object with `__len__`,
    `item`, `orig_shape` and `item_rect`, as `YoloSegDataset` has. The model
    runs in eval mode on its own device and gets its mode back on return."""
    if isinstance(data, str):
        data = YoloSegDataset(data, imgsz=imgsz, channels=channels)
    if variables is not None:
        model.load_state_dict(variables, strict=True)
    training = model.training
    model.eval()
    try:
        metrics = DetMetrics(nc=model.spec.nc)
        for n, hw, batch in validation_batches(
                data, imgsz=imgsz, batch_size=batch_size, max_inst=max_inst,
                rect=rect, stride=stride):
            dets = detect_batch(model, batch["img"], conf=conf, iou=iou,
                                max_det=max_det)
            score_batch(metrics, dets, batch, n, hw)
        return metrics.compute()
    finally:
        model.train(training)
