"""Model-graph specifications of YOLOv12, YOLOv8 and YOLO11 as plain
Python data.

Each layer row is `(from, repeats, block, args)`; `from` is a prior layer
index (-1 = previous), `repeats` is depth-scaled and channel args are
width-scaled. Same rows and scaling rules as the JAX package's
`yolou_tpu/models/specs.py` (copied, not imported).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

# (depth_multiple, width_multiple, max_channels)
YOLOV12_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

YOLOV12_BACKBONE: List[list] = [
    [-1, 1, "Conv", [64, 3, 2]],          # 0  P1/2
    [-1, 1, "Conv", [128, 3, 2]],         # 1  P2/4
    [-1, 2, "C3k2", [256, False, 0.25]],  # 2
    [-1, 1, "Conv", [256, 3, 2]],         # 3  P3/8
    [-1, 2, "C3k2", [512, False, 0.25]],  # 4
    [-1, 1, "Conv", [512, 3, 2]],         # 5  P4/16
    [-1, 4, "A2C2f", [512, True, 4]],     # 6
    [-1, 1, "Conv", [1024, 3, 2]],        # 7  P5/32
    [-1, 4, "A2C2f", [1024, True, 1]],    # 8
]

YOLOV12_HEAD: List[list] = [
    [-1, 1, "Upsample", [2, "nearest"]],   # 9
    [[-1, 6], 1, "Concat", []],            # 10
    [-1, 2, "A2C2f", [512, False, -1]],    # 11
    [-1, 1, "Upsample", [2, "nearest"]],   # 12
    [[-1, 4], 1, "Concat", []],            # 13
    [-1, 2, "A2C2f", [256, False, -1]],    # 14 (P3/8 out)
    [-1, 1, "Conv", [256, 3, 2]],          # 15
    [[-1, 11], 1, "Concat", []],           # 16
    [-1, 2, "A2C2f", [512, False, -1]],    # 17 (P4/16 out)
    [-1, 1, "Conv", [512, 3, 2]],          # 18
    [[-1, 8], 1, "Concat", []],            # 19
    [-1, 2, "C3k2", [1024, True]],         # 20 (P5/32 out)
    [[14, 17, 20], 1, "HEAD", []],         # 21 Detect/Segment per task
]

# YOLOv8 graph (C2f + SPPF; the legacy class branch in the head).
YOLOV8_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.33, 0.25, 1024),
    "s": (0.33, 0.50, 1024),
    "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.25, 512),
}

YOLOV8_BACKBONE: List[list] = [
    [-1, 1, "Conv", [64, 3, 2]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 3, "C2f", [128, True]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 6, "C2f", [256, True]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 6, "C2f", [512, True]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 3, "C2f", [1024, True]],
    [-1, 1, "SPPF", [1024, 5]],
]

YOLOV8_HEAD: List[list] = [
    [-1, 1, "Upsample", [2, "nearest"]],
    [[-1, 6], 1, "Concat", []],
    [-1, 3, "C2f", [512, False]],
    [-1, 1, "Upsample", [2, "nearest"]],
    [[-1, 4], 1, "Concat", []],
    [-1, 3, "C2f", [256, False]],
    [-1, 1, "Conv", [256, 3, 2]],
    [[-1, 12], 1, "Concat", []],
    [-1, 3, "C2f", [512, False]],
    [-1, 1, "Conv", [512, 3, 2]],
    [[-1, 9], 1, "Concat", []],
    [-1, 3, "C2f", [1024, True]],
    [[15, 18, 21], 1, "HEAD", []],
]

# YOLO11 graph (C3k2 + SPPF + C2PSA).
YOLO11_SCALES: Dict[str, Tuple[float, float, int]] = {
    "n": (0.50, 0.25, 1024),
    "s": (0.50, 0.50, 1024),
    "m": (0.50, 1.00, 512),
    "l": (1.00, 1.00, 512),
    "x": (1.00, 1.50, 512),
}

YOLO11_BACKBONE: List[list] = [
    [-1, 1, "Conv", [64, 3, 2]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 2, "C3k2", [256, False, 0.25]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 2, "C3k2", [512, False, 0.25]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 2, "C3k2", [512, True]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 2, "C3k2", [1024, True]],
    [-1, 1, "SPPF", [1024, 5]],
    [-1, 2, "C2PSA", [1024]],            # 10
]

YOLO11_HEAD: List[list] = [
    [-1, 1, "Upsample", [2, "nearest"]],
    [[-1, 6], 1, "Concat", []],
    [-1, 2, "C3k2", [512, False]],       # 13
    [-1, 1, "Upsample", [2, "nearest"]],
    [[-1, 4], 1, "Concat", []],
    [-1, 2, "C3k2", [256, False]],       # 16 (P3)
    [-1, 1, "Conv", [256, 3, 2]],
    [[-1, 13], 1, "Concat", []],
    [-1, 2, "C3k2", [512, False]],       # 19 (P4)
    [-1, 1, "Conv", [512, 3, 2]],
    [[-1, 10], 1, "Concat", []],
    [-1, 2, "C3k2", [1024, True]],       # 22 (P5)
    [[16, 19, 22], 1, "HEAD", []],
]

SPECS = {
    "yolov12": (YOLOV12_BACKBONE, YOLOV12_HEAD, YOLOV12_SCALES),
    "yolov8": (YOLOV8_BACKBONE, YOLOV8_HEAD, YOLOV8_SCALES),
    "yolo11": (YOLO11_BACKBONE, YOLO11_HEAD, YOLO11_SCALES),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def scale_channels(c: int, width: float, max_channels: int) -> int:
    return make_divisible(min(c, max_channels) * width, 8)


def scale_depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1) if n > 1 else n
