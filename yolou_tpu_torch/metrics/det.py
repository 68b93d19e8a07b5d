"""Detection metrics: precision / recall / mAP50 / mAP50-95 (host-side numpy).

Counterpart of `yolou_tpu/metrics/det.py`, kept as this package's own copy
(numpy only, same behaviour): IoU-sorted unique matching at 10 IoU
thresholds (ultralytics `BaseValidator.match_predictions`, including its
`np.unique(return_index)` order) and 101-point interpolated average
precision (ultralytics `compute_ap`).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

IOUV = np.linspace(0.5, 0.95, 10)


def box_iou_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    return inter / (area_a[:, None] + area_b[None, :] - inter + 1e-7)


def match_predictions(pred_boxes: np.ndarray, pred_cls: np.ndarray,
                      gt_boxes: np.ndarray, gt_cls: np.ndarray) -> np.ndarray:
    """TP matrix (n_pred, len(IOUV)), ultralytics validator semantics:
    class-gated (gt, pred) IoU; per threshold, all pairs with IoU >= t are
    sorted by IoU descending, then deduplicated to one match per prediction
    (first = highest IoU) and then one match per GT (first occurrence in the
    resulting prediction-index order: the `np.unique(return_index)` quirk)."""
    tp = np.zeros((len(pred_boxes), len(IOUV)), bool)
    if len(gt_boxes) == 0 or len(pred_boxes) == 0:
        return tp
    iou = box_iou_np(gt_boxes, pred_boxes)             # (n_gt, n_pred)
    iou = iou * (gt_cls[:, None] == pred_cls[None, :])
    for ti, t in enumerate(IOUV):
        matches = np.array(np.nonzero(iou >= t)).T     # (n_pairs, 2) gt,pred
        if matches.shape[0]:
            if matches.shape[0] > 1:
                matches = matches[
                    iou[matches[:, 0], matches[:, 1]].argsort()[::-1]]
                matches = matches[
                    np.unique(matches[:, 1], return_index=True)[1]]
                matches = matches[
                    np.unique(matches[:, 0], return_index=True)[1]]
            tp[matches[:, 1].astype(int), ti] = True
    return tp


def compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """Ultralytics `compute_ap`: precision envelope and 101-point COCO
    interpolation with the `recall[-1] + 0.01` closing sentinel."""
    mrec = np.concatenate(([0.0], recall, [recall[-1] + 0.01]))
    mpre = np.concatenate(([1.0], precision, [0.0]))
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    return float(np.trapezoid(np.interp(x, mrec, mpre), x))


def average_precision(tp: np.ndarray, conf: np.ndarray, n_gt: int) -> np.ndarray:
    """AP per IoU threshold from TP flags (ultralytics ap_per_class curves:
    recall = tpc/(n_gt+eps), precision = tpc/(tpc+fpc), 101-point interp)."""
    if n_gt == 0 or len(tp) == 0:
        return np.zeros(tp.shape[1] if tp.ndim == 2 else len(IOUV))
    order = np.argsort(-conf)
    tp = tp[order]
    eps = 1e-16
    aps = []
    for ti in range(tp.shape[1]):
        tpc = np.cumsum(tp[:, ti]).astype(np.float64)
        fpc = np.cumsum(~tp[:, ti]).astype(np.float64)
        recall = tpc / (n_gt + eps)
        precision = tpc / (tpc + fpc)
        aps.append(compute_ap(recall, precision))
    return np.asarray(aps)


class DetMetrics:
    """Accumulator over images -> precision/recall/mAP50/mAP50-95."""

    def __init__(self, nc: int = 1):
        self.nc = nc
        self.tps: List[np.ndarray] = []
        self.confs: List[np.ndarray] = []
        self.clses: List[np.ndarray] = []
        self.n_gt = np.zeros(nc, np.int64)

    def update(self, pred_boxes, pred_conf, pred_cls, gt_boxes, gt_cls):
        order = np.argsort(-np.asarray(pred_conf))
        pb = np.asarray(pred_boxes)[order]
        pc = np.asarray(pred_cls)[order]
        self.tps.append(match_predictions(pb, pc, np.asarray(gt_boxes),
                                          np.asarray(gt_cls)))
        self.confs.append(np.asarray(pred_conf)[order])
        self.clses.append(pc)
        for c in np.asarray(gt_cls).astype(int):
            self.n_gt[c] += 1

    def compute(self) -> Dict[str, float]:
        if not self.tps:
            return {"precision": 0.0, "recall": 0.0, "map50": 0.0, "map": 0.0}
        tp = np.concatenate(self.tps)
        conf = np.concatenate(self.confs)
        cls = np.concatenate(self.clses)
        ap_per_class = []
        p50s, r50s = [], []
        for c in range(self.nc):
            sel = cls == c
            ap = average_precision(tp[sel], conf[sel], int(self.n_gt[c]))
            if self.n_gt[c] > 0:
                ap_per_class.append(ap)
                n_tp50 = int(tp[sel][:, 0].sum())
                p50s.append(n_tp50 / max(int(sel.sum()), 1))
                r50s.append(n_tp50 / max(int(self.n_gt[c]), 1))
        if not ap_per_class:
            return {"precision": 0.0, "recall": 0.0, "map50": 0.0, "map": 0.0}
        ap = np.stack(ap_per_class)
        return {"precision": float(np.mean(p50s)),
                "recall": float(np.mean(r50s)),
                "map50": float(ap[:, 0].mean()),
                "map": float(ap.mean())}
