"""Dataset YAML config (path / train / val / test / channels / nc / names).

The port's own copy of `yolou_tpu/data/config.py`: same schema, same parser.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional


@dataclasses.dataclass
class DataConfig:
    path: str
    train: str
    val: str
    test: Optional[str] = None
    channels: int = 4
    nc: int = 1
    names: List[str] = dataclasses.field(default_factory=lambda: ["whole_tumor"])

    def split_dir(self, split: str) -> str:
        rel = {"train": self.train, "val": self.val,
               "test": self.test or self.val}[split]
        return rel if os.path.isabs(rel) else os.path.join(self.path, rel)


def _parse_scalar(v: str):
    v = v.strip()
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v.strip("'\"")


def load_data_yaml(path: str) -> DataConfig:
    """Minimal YAML subset parser (flat keys + inline lists) — no pyyaml dep."""
    raw: Dict[str, object] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].rstrip()
            if not line or ":" not in line:
                continue
            k, v = line.split(":", 1)
            k, v = k.strip(), v.strip()
            if v.startswith("[") and v.endswith("]"):
                raw[k] = [_parse_scalar(s) for s in v[1:-1].split(",") if s.strip()]
            elif v:
                raw[k] = _parse_scalar(v)
    return DataConfig(
        path=str(raw.get("path", os.path.dirname(os.path.abspath(path)))),
        train=str(raw.get("train", "images/train")),
        val=str(raw.get("val", "images/val")),
        test=str(raw["test"]) if "test" in raw else None,
        channels=int(raw.get("channels", 3)),
        nc=int(raw.get("nc", 1)),
        names=list(raw.get("names", ["0"])),
    )
