"""Model files: variables and architecture metadata in one `.ckpt` file.

Counterpart of `yolou_tpu/utils/model_io.py`, in the same format: a msgpack
map `{"meta_json": <json>, "variables": <JAX variables>}` with the same
`MAGIC` and meta keys (arch, variant, nc, ch, task, kind, use_logits), the
variables in the JAX package's layout and names. So a model file crosses
both ways: the JAX package's `load_model` reads what `save_model` writes,
and `load_model` here reads what the JAX package writes. JAX variables come
from the port's modules through `tools/convert.py::jax_variables` and go
back through `state_dict_from_jax`.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import torch
from torch import nn

from ..models.segpp import YOLOSegPP, build_segpp
from ..models.yolo import YOLOModel, build_yolo
from ..tools.convert import jax_variables, state_dict_from_jax
from .checkpoint import load_checkpoint, save_checkpoint

MAGIC = "yolou_tpu_model_v1"


def save_model(path: str, model: nn.Module, *,
               state_dict: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write `model` (a `YOLOModel` or `YOLOSegPP`) with the weights of
    `state_dict` (its own by default, e.g. a trainer's EMA weights). The
    meta (arch, variant, nc, ch, task, kind) is the model's own, so a file
    always names the family its variables belong to."""
    spec = model.spec
    segpp = isinstance(model, YOLOSegPP)
    if not segpp and not isinstance(model, YOLOModel):
        raise TypeError(f"save_model takes a YOLOModel or YOLOSegPP, not "
                        f"{type(model).__name__}")
    meta = {"magic": MAGIC, "arch": spec.arch, "variant": spec.variant,
            "nc": spec.nc,
            "ch": spec.channels[0], "task": spec.task,
            "kind": "segpp" if segpp else "yolo",
            "use_logits": model.use_logits if segpp else True}
    save_checkpoint(path, {"meta_json": json.dumps(meta),
                           "variables": jax_variables(model, state_dict)})


def load_model(path: str, dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None) -> nn.Module:
    """Rebuild the model a file describes (`build_yolo` or `build_segpp`)
    on `device` (None: the GPU, an error where there is none) with its
    weights loaded strictly; eval mode."""
    blob = load_checkpoint(path)
    meta = json.loads(blob["meta_json"])
    if meta.get("magic") != MAGIC:
        raise ValueError(f"not a yolou_tpu model file: {path}")
    args = (meta["arch"], meta["variant"], meta["nc"], meta["ch"],
            meta["task"])
    if meta["kind"] == "segpp":
        model = build_segpp(*args, use_logits=meta["use_logits"],
                            dtype=dtype, device=device)
    else:
        model = build_yolo(*args, dtype=dtype, device=device)
    sd = state_dict_from_jax(blob["variables"])
    model.load_state_dict(sd, strict=True)
    return model
