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

(PSA's qkv is head-major on both sides and keeps its channel order.)

plus the non-learned keys of released checkpoints: `num_batches_tracked`
(0) per BatchNorm and the head's fixed DFL projection. `prefix_map`
rewrites the start of a name, as the JAX exporter's argument of that name:
`SEGPP_PREFIX_MAP` turns YOLOSegPP's `yolo.model.{i}` into the `encoder.{i}`
of a reference decoder checkpoint.

The way back: `jax_variables` derives the JAX variables of a port model with
no JAX template, by walking the port's modules. Names alone cannot give the
flax paths, because `torch_name` drops the flax wrapper segments (`dw`, `c3`,
`detect`, `decoder`): the module types say where each goes. It applies the
inverse layouts and the qkv permutation; its tree is what the JAX package's
`init` gives for the same model, path for path and shape for shape.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models.segpp import SegPPDecoder, YOLOSegPP
from ..models.yolo import YOLOModel
from ..nn.attention import (A2C2f, AAttn, ABlock, C2PSA, PSABlock,
                            aattn_qkv_permutation)
from ..nn.blocks import (C2f, C3, C3k, DoubleLightConv, DWConv, ECA,
                         GhostBottleneck, SingleLightConv)
from ..nn.heads import Detect, Segment

# flax wrapper modules that have no torch counterpart (DWConv's "dw",
# C3k's "c3", Segment's "detect", YOLOSegPP's "decoder": its stages' entries
# below carry the reference's `decoder.{i}.{j}` / `output` names themselves)
_WRAPPERS = ("dw", "c3", "detect", "decoder")
_TABLE = {
    "mlp1": "mlp.0", "mlp2": "mlp.1",
    "ffn1": "ffn.0", "ffn2": "ffn.1",             # PSABlock
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
    """AAttn qkv module path -> inverse permutation (role-major -> head-major)
    at the module's head width, c / max(1, c // 32) as A2C2f builds it."""
    inv = {}
    for path, leaf in _flatten(params).items():
        if (path[-4:] == ("attn", "qkv", "conv", "kernel") and np.ndim(leaf) == 4
                and np.shape(leaf)[-1] == 3 * np.shape(leaf)[-2]):
            c = np.shape(leaf)[-2]
            inv[path[:-2]] = np.argsort(aattn_qkv_permutation(
                3 * c, c // max(1, c // 32)))
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


# the decoder's torch names -> flax module names (the inverse of _TABLE's
# decoder entries)
_TABLE_INV = {v: k for k, v in _TABLE.items()
              if v.startswith(("decoder.", "output"))}


def _flax_segments(owner: nn.Module, names: List[str],
                   mod: nn.Module) -> Optional[Tuple[str, ...]]:
    """The flax path segments of `mod`, reached from its nearest
    non-container ancestor `owner` through the torch attribute names
    `names` (one name, or a container's name and its indices). None for a
    module without a JAX counterpart (the fixed DFL projection, the
    decoder's upsample slots); `jax_variables` refuses a tensor left without
    a path."""
    first = names[0]
    if isinstance(owner, YOLOModel) and first == "model":
        return (f"model_{names[1]}",)
    if isinstance(owner, (YOLOSegPP, SegPPDecoder)) and first in ("decoder",
                                                                   "output"):
        seg = _TABLE_INV.get(".".join(names))
        if seg is None:               # the parameter-free upsample slots
            return None
        return ("decoder", seg) if isinstance(owner, YOLOSegPP) else (seg,)
    if isinstance(owner, Detect):
        if first == "dfl":
            return None
        if first in ("cv2", "cv3", "cv4"):
            seg = "_".join(names)
            # Segment nests the detection branches in a Detect named "detect"
            wrap = isinstance(owner, Segment) and first != "cv4"
            return ("detect", seg) if wrap else (seg,)
    if isinstance(owner, (A2C2f, C2f, C2PSA, C3)) and first == "m":
        seg = f"m{names[1]}" + (f"_{names[2]}" if len(names) == 3 else "")
        return (seg, "c3") if isinstance(mod, C3k) else (seg,)
    if isinstance(owner, ABlock) and first == "mlp":
        return (f"mlp{int(names[1]) + 1}",)
    if isinstance(owner, PSABlock) and first == "ffn":
        return (f"ffn{int(names[1]) + 1}",)
    if isinstance(owner, GhostBottleneck) and len(names) == 2:
        slots = {"conv": ("ghost1", "dwmid", "ghost2"),
                 "shortcut": ("sc_dw", "sc_pw")}
        return (slots[first][int(names[1])],)
    if isinstance(owner, DoubleLightConv) and first == "conv":
        return (("conv_a", "conv_b")[int(names[1])],)
    if (isinstance(owner, (DoubleLightConv, SingleLightConv))
            and first == "residual_conv"):
        return ("residual",)
    if isinstance(owner, ECA) and first == "conv":
        return ("conv1d",)
    if len(names) != 1:
        raise ValueError(f"no flax path rule for {type(owner).__name__}."
                         f"{'.'.join(names)}")
    return (first,)


def _jax_layout(a: np.ndarray, mod: nn.Module) -> np.ndarray:
    if isinstance(mod, nn.ConvTranspose2d) and a.ndim == 4:
        return a.transpose(2, 3, 0, 1)[::-1, ::-1]    # (I,O,kh,kw) -> HWIO
    if a.ndim == 4:
        return a.transpose(2, 3, 1, 0)                # (O,I,kh,kw) -> HWIO
    if a.ndim == 3:
        return a.transpose(2, 1, 0)                   # Conv1d (1,1,k)
    return a


def _jax_paths(model: nn.Module) -> Dict[str, Tuple[str, Tuple[str, ...],
                                                   nn.Module,
                                                   Optional[np.ndarray]]]:
    """state_dict name -> (collection, flax path, owning module, qkv
    permutation or None) for every entry with a JAX counterpart. Entries
    without one (`num_batches_tracked`, the DFL projection) are absent."""
    out: Dict = {}
    leaf_names = {"weight": ("params", None), "bias": ("params", "bias"),
                  "running_mean": ("batch_stats", "mean"),
                  "running_var": ("batch_stats", "var"),
                  "gamma": ("params", "gamma")}     # residual A2C2f

    def visit(mod, prefix, path, pending, owner, perm):
        if type(mod) in (nn.ModuleList, nn.Sequential):
            for name, child in mod.named_children():
                visit(child, prefix + name + ".", path, pending + [name],
                      owner, perm)
            return
        if pending:
            segs = _flax_segments(owner, pending, mod)
            if segs is None:
                return
            path = path + segs
            if isinstance(owner, AAttn) and pending == ["qkv"]:
                perm = owner.perm.cpu().numpy()   # head-major -> role-major
        if isinstance(mod, DWConv):
            path = path + ("dw",)
        tensors = list(mod.named_parameters(recurse=False)) + list(
            mod.named_buffers(recurse=False))
        for name, _ in tensors:
            if name not in leaf_names:
                continue
            coll, leaf = leaf_names[name]
            if leaf is None:
                leaf = ("kernel" if isinstance(mod, (nn.Conv1d, nn.Conv2d,
                                                     nn.ConvTranspose2d))
                        else "scale")
            out[prefix + name] = (coll, path + (leaf,), mod, perm)
        for name, child in mod.named_children():
            visit(child, prefix + name + ".", path, [name], mod, perm)

    visit(model, "", (), [], None, None)
    return out


def jax_variables(model: nn.Module,
                  state_dict: Optional[Dict[str, torch.Tensor]] = None
                  ) -> Dict:
    """The JAX package's variables `{"params": ..., "batch_stats": ...}` of
    a `YOLOModel` or `YOLOSegPP` as nested dicts of numpy arrays of their
    own (no view of a tensor, which training moves on), from `state_dict`
    (the model's own by default), with no JAX template."""
    sd = model.state_dict() if state_dict is None else state_dict
    paths = _jax_paths(model)
    out: Dict = {}
    for name, t in sd.items():
        if name not in paths:
            if name.endswith("num_batches_tracked") or ".dfl." in name:
                continue
            raise KeyError(f"{name} has no JAX counterpart")
        coll, path, mod, perm = paths[name]
        arr = _jax_layout(t.detach().cpu().numpy(), mod)
        if perm is not None:
            arr = arr[..., perm]
        node = out.setdefault(coll, {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = np.array(arr, order="C")    # never a view of t
    return out
