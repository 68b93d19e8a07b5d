"""YOLO segmentation/detection model: spec parser + graph executor (PyTorch).

Counterpart of `yolou_tpu/models/yolo.py`. The module tree is ultralytics'
(`model.{i}.<...>`), so released state_dicts load unchanged. `forward`
returns a `YoloOutputs` whose `raw` tuple holds the per-level NCHW maps and
whose `preds` is the (B, N, 4+nc[+nm]) tensor NMS consumes (None in training
mode: the loss reads `raw`, `mask_coefs` and `protos`). The JAX TPU
options `stem_s2d`, `fuse_cls_entry` and `pad_head_p5` are layout rewrites of
the same function and are not carried over. `mega_kernel` is: it routes the
backbone's A2C2f attention blocks at eval through the whole-block kernel
(`kernels/a2c2f.py`), off by default as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.attention import A2C2f, C2PSA
from ..nn.blocks import C2f, C3k2, Concat, Conv, SPPF
from ..nn.heads import Detect, Segment, decode_detections
from . import specs


@dataclasses.dataclass
class YoloOutputs:
    raw: Tuple[torch.Tensor, ...]          # per-level NCHW [4*reg_max | nc]
    preds: Optional[torch.Tensor]          # (B, N, 4+nc[+nm]) f32
    mask_coefs: Optional[torch.Tensor]     # (B, N, nm), segment only
    protos: Optional[torch.Tensor]         # (B, nm, Hm, Wm), segment only
    taps: Dict[int, torch.Tensor]          # requested intermediate features


@dataclasses.dataclass(frozen=True)
class LayerDef:
    frm: Tuple[int, ...]
    repeats: int
    block: str
    args: Tuple


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Fully resolved (scaled) model graph."""

    layers: Tuple[LayerDef, ...]
    channels: Tuple[int, ...]      # channels[0] = input, channels[i+1] = layer i
    head_from: Tuple[int, ...]
    strides: Tuple[int, ...]
    nc: int
    task: str                      # "detect" | "segment"
    nm: int = 32
    npr: int = 64
    reg_max: int = 16
    # ultralytics Detect.legacy: the v8 family's plain-Conv class branch
    legacy_head: bool = False
    # the family and scale the graph was parsed from, which a model file
    # records
    arch: str = "yolov12"
    variant: str = "n"


def parse_model_spec(arch: str = "yolov12", variant: str = "n", nc: int = 1,
                     ch: int = 4, task: str = "detect") -> ModelSpec:
    if arch not in specs.SPECS:
        raise ValueError(f"unknown arch {arch!r}; have {sorted(specs.SPECS)}")
    backbone, head, scales = specs.SPECS[arch]
    depth, width, max_ch = scales[variant]
    layers, channels = [], [ch]
    head_from: Tuple[int, ...] = ()
    for f, n, block, args in backbone + head:
        frm = tuple(f) if isinstance(f, list) else (f,)
        cin = channels[frm[0] + 1] if frm[0] != -1 else channels[-1]
        n_scaled = specs.scale_depth(n, depth)
        if block == "Conv":
            c2 = specs.scale_channels(args[0], width, max_ch)
            layers.append(LayerDef(frm, 1, "Conv", (c2, args[1], args[2])))
        elif block in ("C3k2", "C2f", "A2C2f", "SPPF", "C2PSA"):
            c2 = specs.scale_channels(args[0], width, max_ch)
            layers.append(LayerDef(frm, n_scaled, block, (c2,) + tuple(args[1:])))
        elif block == "Upsample":
            c2 = cin
            layers.append(LayerDef(frm, 1, "Upsample", tuple(args)))
        elif block == "Concat":
            c2 = sum(channels[j + 1] if j != -1 else channels[-1] for j in frm)
            layers.append(LayerDef(frm, 1, "Concat", ()))
        elif block == "HEAD":
            c2, head_from = 0, frm
            layers.append(LayerDef(frm, 1, "HEAD", ()))
        else:
            raise NotImplementedError(f"block {block!r} is not ported")
        channels.append(c2)
    return ModelSpec(layers=tuple(layers), channels=tuple(channels),
                     head_from=head_from, strides=(8, 16, 32), nc=nc,
                     task=task, npr=specs.scale_channels(256, width, max_ch),
                     legacy_head=arch == "yolov8", arch=arch, variant=variant)


class YOLOModel(nn.Module):
    """Graph executor for a parsed ModelSpec (NCHW).

    Parameters are float32; `dtype` is the compute dtype the input is cast
    to (bfloat16 on the card, float32 for exact checks)."""

    def __init__(self, spec: ModelSpec, dtype: torch.dtype = torch.float32,
                 mega_kernel: bool = False):
        super().__init__()
        self.spec, self.dtype = spec, dtype
        mods = []
        for i, layer in enumerate(spec.layers):
            j = layer.frm[0]
            cin = spec.channels[j + 1] if j != -1 else spec.channels[i]
            a = layer.args
            if layer.block == "Conv":
                m = Conv(cin, a[0], a[1], a[2])
            elif layer.block == "C3k2":
                m = C3k2(cin, a[0], layer.repeats,
                         c3k=a[1] if len(a) > 1 else False,
                         e=a[2] if len(a) > 2 else 0.5)
            elif layer.block == "C2f":
                m = C2f(cin, a[0], layer.repeats,
                        shortcut=a[1] if len(a) > 1 else False)
            elif layer.block == "SPPF":
                m = SPPF(cin, a[0], a[1])
            elif layer.block == "C2PSA":
                m = C2PSA(cin, a[0], layer.repeats)
            elif layer.block == "A2C2f":
                area = a[2] if len(a) > 2 else 1
                area = area if isinstance(area, int) and area > 0 else 1
                m = A2C2f(cin, a[0], layer.repeats, a2=a[1], area=area,
                          mega_kernel=mega_kernel)
            elif layer.block == "Upsample":
                if tuple(a) != (2, "nearest"):
                    raise NotImplementedError(f"Upsample{tuple(a)}")
                m = nn.Upsample(scale_factor=2, mode="nearest")
            elif layer.block == "Concat":
                m = Concat()
            else:  # HEAD
                ch = tuple(spec.channels[k + 1] for k in layer.frm)
                m = (Segment(spec.nc, spec.nm, spec.npr, ch, spec.reg_max,
                             spec.legacy_head)
                     if spec.task == "segment"
                     else Detect(spec.nc, ch, spec.reg_max, spec.legacy_head))
            mods.append(m)
        self.model = nn.ModuleList(mods)

    def forward(self, x: torch.Tensor, taps: Sequence[int] = (),
                stop_at: Optional[int] = None) -> YoloOutputs:
        """Run the graph on NCHW `x`. `taps` returns intermediates by layer
        index; `stop_at` stops before layer `stop_at`."""
        spec = self.spec
        x = x.to(self.dtype)
        ys: list = []
        tap_out: Dict[int, torch.Tensor] = {}
        head_out = None

        def get(j: int):
            return ys[j] if j != -1 else (ys[-1] if ys else x)

        for i, (layer, m) in enumerate(zip(spec.layers, self.model)):
            if stop_at is not None and i >= stop_at:
                break
            if layer.block == "Concat":
                y = m([get(j) for j in layer.frm])
            elif layer.block == "HEAD":
                feats = [get(j) for j in layer.frm]
                if spec.task == "segment":
                    raw, mc, protos = m(feats)
                    head_out = (tuple(raw), mc, protos)
                else:
                    head_out = (tuple(m(feats)), None, None)
                y = feats[0]
            else:
                y = m(get(layer.frm[0]))
            ys.append(y)
            if i in taps:
                tap_out[i] = y

        if head_out is None:
            return YoloOutputs(raw=(), preds=None, mask_coefs=None,
                               protos=None, taps=tap_out)
        raw, mc, protos = head_out
        preds = None
        if not self.training:
            preds = decode_detections(raw, spec.strides, spec.nc, spec.reg_max)
            if mc is not None:
                preds = torch.cat([preds, mc.to(preds.dtype)], -1)
        return YoloOutputs(raw=raw, preds=preds, mask_coefs=mc, protos=protos,
                           taps=tap_out)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random init: conv weights ~ N(0, 1/fan_in) (the LeCun-normal
    scale flax uses), conv biases 0, BatchNorm at identity statistics.
    Draws on the CPU from `generator`, then copies to the parameter's device,
    so one seed gives the same weights on every device."""
    for m in model.modules():
        if (isinstance(m, (nn.Conv1d, nn.Conv2d, nn.ConvTranspose2d))
                and m.weight.requires_grad):
            w = m.weight
            fan_in = (w.shape[0] * w[0, 0].numel()
                      if isinstance(m, nn.ConvTranspose2d) else w[0].numel())
            w.copy_(torch.randn(w.shape, generator=generator) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def inflate_stem_to_4ch(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """3 -> 4 channel stem inflation of a state_dict: the first conv's
    kernel (`model.0.conv.weight`, (O, I, kh, kw); under any prefix, e.g.
    YOLO-Seg++'s `yolo.`) gains the mean of its RGB kernels as input channel
    4. A 4-channel stem comes back unchanged; any other input-channel count
    raises. Returns a new dict (tensors other than the stem's are shared)."""
    keys = [k for k in state_dict
            if k == "model.0.conv.weight" or k.endswith(".model.0.conv.weight")]
    if not keys:
        raise KeyError("stem conv kernel not found (model.0.conv.weight)")
    w = state_dict[keys[0]]
    if w.shape[1] == 4:
        return state_dict
    if w.shape[1] != 3:
        raise ValueError(f"stem inflation needs a 3-channel stem, got "
                         f"{tuple(w.shape)}")
    out = dict(state_dict)
    # XLA's mean: the sum in channel order, times the reciprocal of the count
    mean = (w[:, 0:1] + w[:, 1:2] + w[:, 2:3]) * (1 / 3)
    out[keys[0]] = torch.cat([w, mean], 1)
    return out


def resolve_device(device: torch.device | str | None) -> torch.device:
    """The device an entry point runs on: `device` as given, the current
    CUDA device for None. Raises where None is given and there is no GPU, so
    that nothing runs on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on the GPU by default; pass "
            "device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def build_yolo(arch: str = "yolov12", variant: str = "n", nc: int = 1,
               ch: int = 4, task: str = "detect",
               dtype: torch.dtype = torch.float32,
               device: torch.device | str | None = None,
               seed: Optional[int] = None,
               mega_kernel: bool = False) -> YOLOModel:
    """Build a model in eval mode on `device`; None means the GPU (an error
    where there is none: pass "cpu" to ask for the CPU). With `seed`, weights
    are drawn from a `torch.Generator` seeded with it; otherwise they keep
    torch's default init and are meant to be replaced by `load_state_dict`.
    `mega_kernel` runs each eligible A2C2f attention block as one kernel."""
    device = resolve_device(device)
    model = YOLOModel(parse_model_spec(arch, variant, nc, ch, task), dtype,
                      mega_kernel)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
