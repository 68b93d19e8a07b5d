"""Results objects — API-compatible surface of ultralytics Results/Boxes/Masks
as exercised by the reference (generate_heatmaps.py:65-75 iterates
`result.boxes`, reads `.conf`, `.xywh`, `.path`; predictors attach `.masks`).
Plain numpy dataclasses, ragged-free on the host side.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class Box:
    """One detection row: xyxy, conf, cls (orig-image coordinates)."""

    data: np.ndarray  # (6,)

    @property
    def xyxy(self) -> np.ndarray:
        return self.data[None, :4]

    @property
    def xywh(self) -> np.ndarray:
        x1, y1, x2, y2 = self.data[:4]
        return np.asarray([[(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1]],
                          np.float32)

    @property
    def conf(self) -> np.ndarray:
        return self.data[4:5]

    @property
    def cls(self) -> np.ndarray:
        return self.data[5:6]


@dataclasses.dataclass
class Boxes:
    data: np.ndarray  # (n, 6) xyxy conf cls

    def __len__(self) -> int:
        return len(self.data)

    def __bool__(self) -> bool:
        return len(self.data) > 0

    def __iter__(self) -> Iterator[Box]:
        return (Box(row) for row in self.data)

    def __getitem__(self, i) -> Box:
        return Box(self.data[i])

    @property
    def xyxy(self) -> np.ndarray:
        return self.data[:, :4]

    @property
    def xywh(self) -> np.ndarray:
        x1y1 = self.data[:, :2]
        x2y2 = self.data[:, 2:4]
        return np.concatenate([(x1y1 + x2y2) / 2, x2y2 - x1y1], axis=1)

    @property
    def conf(self) -> np.ndarray:
        return self.data[:, 4]

    @property
    def cls(self) -> np.ndarray:
        return self.data[:, 5]


@dataclasses.dataclass
class Masks:
    data: np.ndarray  # (n, H, W) float {0,1}

    def __len__(self) -> int:
        return len(self.data)

    @property
    def xy(self) -> List[np.ndarray]:
        """Mask contours in pixel coords (cv2 when available)."""
        try:
            import cv2
        except ImportError:  # pragma: no cover
            return []
        out = []
        for m in self.data:
            cnts, _ = cv2.findContours(m.astype(np.uint8), cv2.RETR_EXTERNAL,
                                       cv2.CHAIN_APPROX_SIMPLE)
            out.append(cnts[0].reshape(-1, 2).astype(np.float32)
                       if cnts else np.zeros((0, 2), np.float32))
        return out


@dataclasses.dataclass
class Results:
    orig_img: Optional[np.ndarray]
    path: str
    names: Dict[int, str]
    boxes: Boxes
    masks: Optional[Masks] = None

    def __len__(self) -> int:
        return len(self.boxes)

    def plot(self, line_width: int = 2, alpha: float = 0.4) -> np.ndarray:
        """Annotated BGR image: boxes, labels, translucent masks (the
        ultralytics Results.plot surface)."""
        import cv2

        assert self.orig_img is not None, "predictor ran with keep_orig_images=False"
        img = np.ascontiguousarray(self.orig_img[..., :3]).astype(np.uint8)
        palette = [(56, 56, 255), (31, 112, 255), (29, 178, 255),
                   (49, 210, 207), (10, 249, 72), (23, 204, 146)]
        if self.masks is not None and len(self.masks):
            for i, m in enumerate(self.masks.data):
                color = np.asarray(palette[i % len(palette)], np.float32)
                mm = m > 0.5
                img[mm] = (img[mm] * (1 - alpha) + color * alpha).astype(np.uint8)
        for i, row in enumerate(self.boxes.data):
            x1, y1, x2, y2, conf, cls = row
            color = palette[i % len(palette)]
            cv2.rectangle(img, (int(x1), int(y1)), (int(x2), int(y2)),
                          color, line_width)
            label = f"{self.names.get(int(cls), int(cls))} {conf:.2f}"
            cv2.putText(img, label, (int(x1), max(int(y1) - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
        return img

    def save(self, path: str, **kwargs) -> None:
        import cv2
        cv2.imwrite(path, self.plot(**kwargs))
