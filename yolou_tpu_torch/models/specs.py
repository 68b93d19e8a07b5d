"""Model-graph specification of YOLOv12 as plain Python data.

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

SPECS = {
    "yolov12": (YOLOV12_BACKBONE, YOLOV12_HEAD, YOLOV12_SCALES),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def scale_channels(c: int, width: float, max_channels: int) -> int:
    return make_divisible(min(c, max_channels) * width, 8)


def scale_depth(n: int, depth: float) -> int:
    return max(round(n * depth), 1) if n > 1 else n
