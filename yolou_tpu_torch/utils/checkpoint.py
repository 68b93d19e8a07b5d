"""Single-file msgpack checkpoints in the JAX package's `.ckpt` encoding.

Counterpart of `save_checkpoint` / `load_checkpoint` in
`yolou_tpu/utils/checkpoint.py`, over this package's own codec
(`utils/msgpack_lite.py`): the JAX package reads what `save_checkpoint`
writes, and `load_checkpoint` reads what it writes. The write is atomic: a
`.tmp` file beside the target, then `os.replace`. The JAX package's orbax
directory checkpoints are not carried over.
"""

from __future__ import annotations

import os
from typing import Any

from .msgpack_lite import packb, unpackb


def save_checkpoint(path: str, tree: Any) -> None:
    """Write `tree` (nested dicts of numpy arrays, torch tensors and
    scalars) to `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = packb(tree)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Any:
    """The tree `path` holds (numpy leaves; bfloat16 as torch tensors)."""
    with open(path, "rb") as f:
        return unpackb(f.read())
