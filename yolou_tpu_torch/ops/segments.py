"""Polygon segment utilities (ultralytics `ops.resample_segments` /
`segments2boxes`), numpy only.

Counterpart of `yolou_tpu/ops/segments.py`.
"""

from __future__ import annotations

from typing import List

import numpy as np


def resample_segments(segments: List[np.ndarray], n: int = 1000) -> List[np.ndarray]:
    """Up-sample each closed polygon to exactly n points (linear interp)."""
    out = []
    for s in segments:
        s = np.asarray(s, np.float32)
        if len(s) == 0:
            out.append(np.zeros((n, 2), np.float32))
            continue
        closed = np.concatenate([s, s[:1]], axis=0)
        x = np.linspace(0, len(closed) - 1, n)
        xp = np.arange(len(closed))
        out.append(np.stack([np.interp(x, xp, closed[:, i])
                             for i in range(2)], axis=-1).astype(np.float32))
    return out


def segments2boxes(segments: List[np.ndarray]) -> np.ndarray:
    """Polygons -> (n, 4) xywh boxes (normalized coords pass through)."""
    boxes = []
    for s in segments:
        s = np.asarray(s, np.float32)
        if len(s) == 0:
            boxes.append([0, 0, 0, 0])
            continue
        x1, y1 = s[:, 0].min(), s[:, 1].min()
        x2, y2 = s[:, 0].max(), s[:, 1].max()
        boxes.append([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1])
    return np.asarray(boxes, np.float32)
