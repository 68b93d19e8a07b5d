"""YOLO-Seg++: a frozen YOLO encoder, a small U-decoder and the detector's
class-logit map as the bottleneck conditioning (PyTorch, NCHW).

Counterpart of `yolou_tpu/models/segpp.py`. The backbone runs once: the
skips (layers 2 and 4) are taps of the graph executor, and in the fused pass
the conditioning map is the sigmoid of the last channel of the same pass's
stride-8 raw head output, with no z-score (the evaluation-time conditioning
of the reference; training on precomputed objectmaps z-scores them in the
dataset). `use_logits=False` is the ablation without the conditioning map.

Decoder topology: at stride 8 concat [skip 4, logit map] -> C3Ghost(96) +
ECA; bilinear x2 -> DoubleLightConv(64); concat skip 2 -> C3Ghost(64) + ECA;
x2 -> DoubleLightConv(32); x2 -> DoubleLightConv(16); 1x1 conv -> one logit
channel at full resolution. Module names are the reference's
(`decoder.{i}.{j}`, `output`), so its state_dicts load unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import nn

from ..nn.blocks import (C3Ghost, DoubleLightConv, ECA, conv_in_dtype,
                         upsample_bilinear_torch)
from .yolo import (ModelSpec, YOLOModel, YoloOutputs, init_weights,
                   parse_model_spec, resolve_device)

SKIP_TAPS: Tuple[int, int] = (2, 4)   # encoder layers whose outputs are skips
ENCODER_LAYERS = 5                    # the encoder is backbone layers 0..4


class Upsample2x(nn.Module):
    """Bilinear x2 (half-pixel centres); parameter-free, slot 0 of the
    reference's upsampling stages."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_bilinear_torch(x, (2 * x.shape[2], 2 * x.shape[3]))


def decoder_stages(c_skip2: int, c_skip4: int, use_logits: bool):
    """(decoder ModuleList, output conv) with the reference's names."""
    stages = nn.ModuleList([
        nn.Sequential(C3Ghost(c_skip4 + int(use_logits), 96, 1), ECA()),
        nn.Sequential(Upsample2x(), DoubleLightConv(96, 64)),
        nn.Sequential(C3Ghost(64 + c_skip2, 64, 1), ECA()),
        nn.Sequential(Upsample2x(), DoubleLightConv(64, 32)),
        nn.Sequential(Upsample2x(), DoubleLightConv(32, 16))])
    return stages, nn.Conv2d(16, 1, 1)


def run_decoder(stages: nn.ModuleList, output: nn.Conv2d,
                skip2: torch.Tensor, skip4: torch.Tensor,
                logits: Optional[torch.Tensor]) -> torch.Tensor:
    """Mask logits (B, 1, H, W) f32 from the skips (NCHW) and, when given,
    the conditioning map (B, 1, H/8, W/8)."""
    x = skip4 if logits is None else torch.cat(
        [skip4, logits.to(skip4.dtype)], 1)
    x = stages[1](stages[0](x))
    x = stages[2](torch.cat([x, skip2], 1))
    x = stages[4](stages[3](x))
    return conv_in_dtype(output, x).float()


class SegPPDecoder(nn.Module):
    """The trainable U-decoder head (about 64 K parameters)."""

    def __init__(self, use_logits: bool = True, c_skip2: int = 64,
                 c_skip4: int = 128):
        super().__init__()
        self.use_logits = use_logits
        self.decoder, self.output = decoder_stages(c_skip2, c_skip4,
                                                   use_logits)

    def forward(self, skip2: torch.Tensor, skip4: torch.Tensor,
                logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.use_logits and logits is None:
            raise ValueError("use_logits=True needs the conditioning map")
        return run_decoder(self.decoder, self.output, skip2, skip4,
                           logits if self.use_logits else None)


class YOLOSegPP(nn.Module):
    """Full model: the YOLO graph (frozen) and the decoder (trainable).

    Call modes:
      * `logits` given -> encoder slice only (the graph stops before layer
        5): decoder training on precomputed objectmaps;
      * `logits=None` -> fused full pass: the detector's outputs and the
        decoder's mask from one backbone execution.
    Returns (mask_logits (B, 1, H, W) f32, YoloOutputs).

    The encoder is frozen: `yolo` stays in eval mode whatever `train()` is
    called on this module, runs without autograd, and its taps are detached.

    state_dict names: `yolo.model.{i}.*` (the whole YOLO graph, which the
    fused pass needs), `decoder.{i}.{j}.*` and `output.*`. A reference
    decoder checkpoint holds `encoder.{0..4}.*`, `decoder.*` and `output.*`:
    `load_reference_state_dict` fills `yolo.model.{0..4}`, `decoder` and
    `output` from it and leaves `yolo.model.{5..}` (the rest of the backbone,
    the neck and the head) as they are; those come from the detector's own
    state_dict (`model.yolo.load_state_dict`).
    """

    def __init__(self, spec: ModelSpec, use_logits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.spec, self.use_logits, self.dtype = spec, use_logits, dtype
        self.yolo = YOLOModel(spec, dtype)
        self.decoder, self.output = decoder_stages(
            spec.channels[SKIP_TAPS[0] + 1], spec.channels[SKIP_TAPS[1] + 1],
            use_logits)
        self.yolo.eval()

    def train(self, mode: bool = True) -> "YOLOSegPP":
        super().train(mode)
        self.yolo.eval()          # running BatchNorm statistics, always
        return self

    def decoder_parameters(self) -> Iterator[nn.Parameter]:
        """The trainable parameters: everything but the frozen encoder."""
        for name, p in self.named_parameters():
            if not name.startswith("yolo."):
                yield p

    def load_reference_state_dict(self, state_dict: Dict[str, torch.Tensor]):
        """Load a reference decoder checkpoint (`encoder.{i}`, `decoder`,
        `output`). Returns torch's (missing, unexpected) keys; missing are
        the `yolo.model.{5..}` names the checkpoint does not hold."""
        renamed = {("yolo.model." + k[len("encoder."):]
                    if k.startswith("encoder.") else k): v
                   for k, v in state_dict.items()}
        return self.load_state_dict(renamed, strict=False)

    def forward(self, x: torch.Tensor, logits: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, YoloOutputs]:
        full = logits is None
        with torch.no_grad():
            out = self.yolo(x, taps=SKIP_TAPS,
                            stop_at=None if full else ENCODER_LAYERS)
            if full and self.use_logits:
                # the stride-8 raw map's last (class-logit) channel
                logits = torch.sigmoid(out.raw[0][:, -1:].float())
        mask_logits = run_decoder(
            self.decoder, self.output, out.taps[SKIP_TAPS[0]].detach(),
            out.taps[SKIP_TAPS[1]].detach(),
            logits if self.use_logits else None)
        return mask_logits, out


def build_segpp(arch: str = "yolov12", variant: str = "n", nc: int = 1,
                ch: int = 4, task: str = "detect", use_logits: bool = True,
                dtype: torch.dtype = torch.float32,
                device: torch.device | str | None = None,
                seed: Optional[int] = None) -> YOLOSegPP:
    """Build YOLO-Seg++ in eval mode on `device`; None means the GPU (an
    error where there is none: pass "cpu" to ask for the CPU). With `seed`,
    weights are drawn from a `torch.Generator` seeded with it."""
    device = resolve_device(device)
    model = YOLOSegPP(parse_model_spec(arch, variant, nc, ch, task),
                      use_logits, dtype)
    if seed is not None:
        init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval()
