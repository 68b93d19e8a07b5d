"""JAX/flax variables -> the port's (ultralytics-named) state_dict.

Takes the `{"params": ..., "batch_stats": ...}` tree of the JAX package's
YOLO model, or of its YOLOSegPP (the YOLO graph under `yolo`, the decoder
under `decoder`), as nested dicts of numpy arrays and returns a torch
state_dict that `YOLOModel` / `YOLOSegPP.load_state_dict(..., strict=True)`
accepts. It applies the
same name rules, layout transposes and AAttn qkv channel permutation as the
JAX package's `tools/torch2jax.py::jax_to_torch_state_dict`, reimplemented
here so that this package never imports JAX:

  conv kernel (kh,kw,I,O)             -> weight (O,I,kh,kw)
  ConvTranspose kernel (kh,kw,I,O)    -> weight (I,O,kh,kw), spatially flipped
  BatchNorm scale/bias, mean/var      -> weight/bias, running_mean/var
  ECA Conv1d kernel (k,1,1)           -> weight (1,1,k)
  AAttn qkv (role-major thirds)       -> head-major interleave (ultralytics)

plus the non-learned keys of released checkpoints: `num_batches_tracked`
(0) per BatchNorm and the head's fixed DFL projection. `prefix_map`
rewrites the start of a name, as the JAX exporter's argument of that name:
`SEGPP_PREFIX_MAP` turns YOLOSegPP's `yolo.model.{i}` into the `encoder.{i}`
of a reference decoder checkpoint.

`variables_from_state_dict` is the way back, for holding a state the port
has trained (parameters, EMA, BatchNorm running statistics) against the JAX
package's after the same steps.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..nn.attention import aattn_qkv_permutation

# flax wrapper modules that have no torch counterpart (DWConv's "dw",
# C3k's "c3", Segment's "detect", YOLOSegPP's "decoder": its stages' entries
# below carry the reference's `decoder.{i}.{j}` / `output` names themselves)
_WRAPPERS = ("dw", "c3", "detect", "decoder")
_TABLE = {
    "mlp1": "mlp.0", "mlp2": "mlp.1",
    # GhostBottleneck.conv is a 3-slot Sequential at either stride
    "ghost1": "conv.0", "ghost2": "conv.2", "dwmid": "conv.1",
    "sc_dw": "shortcut.0", "sc_pw": "shortcut.1",
    "conv_a": "conv.0", "conv_b": "conv.1",       # DoubleLightConv
    "conv1d": "conv",                             # ECA's Conv1d
    "residual": "residual_conv",
    # the decoder's ModuleList of Sequentials; slot 0 of an upsampling stage
    # is the parameter-free upsample
    "mix0": "decoder.0.0", "eca0": "decoder.0.1", "up1": "decoder.1.1",
    "mix2": "decoder.2.0", "eca2": "decoder.2.1", "up3": "decoder.3.1",
    "up4": "decoder.4.1", "output": "output",
}
# YOLOSegPP holds the whole YOLO graph under yolo.model.{i}; a reference
# decoder checkpoint stores the encoder slice as encoder.{i}
SEGPP_PREFIX_MAP = {"yolo.model": "encoder"}


def _module_segment(seg: str) -> Optional[str]:
    if seg in _WRAPPERS:
        return None
    if seg.startswith("model_"):
        return f"model.{seg[6:]}"
    m = re.fullmatch(r"(cv[234])_(\d+)_(\d+)(?:_(\d+))?", seg)
    if m:
        return ".".join(g for g in m.groups() if g is not None)
    m = re.fullmatch(r"m(\d+)_(\d+)", seg)
    if m:
        return f"m.{m.group(1)}.{m.group(2)}"
    m = re.fullmatch(r"m(\d+)", seg)
    if m:
        return f"m.{m.group(1)}"
    return _TABLE.get(seg, seg)


def torch_name(path: Tuple[str, ...], collection: str,
               prefix_map: Optional[Dict[str, str]] = None) -> str:
    """Flax variable path (module segments + leaf) -> ultralytics name, its
    start rewritten by the first entry of `prefix_map` that matches."""
    *mods, leaf = path
    segs: List[str] = [t for t in map(_module_segment, mods) if t is not None]
    if collection == "batch_stats":
        leaf = {"mean": "running_mean", "var": "running_var"}[leaf]
    elif leaf in ("kernel", "scale"):
        leaf = "weight"
    name = ".".join(segs + [leaf])
    for ours, theirs in (prefix_map or {}).items():
        if name.startswith(ours):
            return theirs + name[len(ours):]
    return name


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        p = prefix + (k,)
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def _torch_layout(a: np.ndarray, path: Tuple[str, ...]) -> np.ndarray:
    if a.ndim == 4:
        if "upsample" in path:   # flax ConvTranspose -> torch ConvTranspose2d
            return np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
        return np.ascontiguousarray(a.transpose(3, 2, 0, 1))
    if a.ndim == 3:              # flax 1D conv (k, 1, 1) -> Conv1d (1, 1, k)
        return np.ascontiguousarray(a.transpose(2, 1, 0))
    return a


def _qkv_modules(params) -> Dict[Tuple[str, ...], np.ndarray]:
    """AAttn qkv module path -> inverse permutation (role-major -> head-major)."""
    inv = {}
    for path, leaf in _flatten(params).items():
        if (path[-4:] == ("attn", "qkv", "conv", "kernel") and np.ndim(leaf) == 4
                and np.shape(leaf)[-1] == 3 * np.shape(leaf)[-2]):
            inv[path[:-2]] = np.argsort(aattn_qkv_permutation(np.shape(leaf)[-1]))
    return inv


def _leaves(variables: Dict):
    """(collection, path, leaf, qkv inverse permutation or None) per leaf."""
    inv_qkv = _qkv_modules(variables.get("params", {}))
    for coll in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(coll, {})).items():
            yield coll, path, leaf, inv_qkv.get(path[:-2])


def state_dict_from_jax(variables: Dict,
                        prefix_map: Optional[Dict[str, str]] = None
                        ) -> Dict[str, torch.Tensor]:
    """JAX YOLO or YOLOSegPP variables (nested dicts of numpy arrays) ->
    state_dict."""
    out: Dict[str, np.ndarray] = {}
    for coll, path, leaf, inv in _leaves(variables):
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating):
            arr = arr.astype(np.float32)
        if inv is not None:
            arr = arr[..., inv] if arr.ndim == 4 else arr[inv]
        name = torch_name(path, coll, prefix_map)
        if name in out:
            raise ValueError(f"duplicate torch name {name} from {path}")
        out[name] = _torch_layout(arr, path)
    for name in list(out):
        if name.endswith(".running_mean"):
            out[name[:-len("running_mean")] + "num_batches_tracked"] = (
                np.zeros((), np.int64))
        m = re.fullmatch(r"(.*)\.cv2\.0\.2\.weight", name)
        if m:
            reg_max = out[name].shape[0] // 4
            out[f"{m.group(1)}.dfl.conv.weight"] = (
                np.arange(reg_max, dtype=np.float32).reshape(1, reg_max, 1, 1))
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def variables_from_state_dict(state_dict: Dict[str, torch.Tensor],
                              like: Dict,
                              prefix_map: Optional[Dict[str, str]] = None
                              ) -> Dict:
    """The inverse of `state_dict_from_jax`: a tree of numpy arrays with the
    structure (and leaf shapes) of the JAX variables `like`, filled from
    `state_dict`. Keys without a JAX counterpart (`num_batches_tracked`, the
    DFL projection) are left behind."""
    out: Dict = {}
    for coll, path, leaf, inv in _leaves(like):
        arr = state_dict[torch_name(path, coll, prefix_map)]
        arr = arr.detach().cpu().numpy()
        if arr.ndim == 3:
            arr = arr.transpose(2, 1, 0)
        if arr.ndim == 4:
            if "upsample" in path:
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            else:
                arr = arr.transpose(2, 3, 1, 0)
        if inv is not None:
            perm = np.argsort(inv)
            arr = arr[..., perm] if arr.ndim == 4 else arr[perm]
        if arr.shape != np.shape(leaf):
            raise ValueError(f"{path}: {arr.shape} != {np.shape(leaf)}")
        node = out.setdefault(coll, {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.ascontiguousarray(arr)
    return out
