"""Seeded weights and inputs, made on the run's device.

Every convolution's weight comes from one `torch.randn` call on a
generator seeded with the run's seed, scaled by fan_in ** -0.5 (the
LeCun-normal scale of the program's own `init_weights`); biases are zero.
A random network of that kind is either vanishing or chaotic, so (as the
program's `chip_smoke.py` does) every BatchNorm is then calibrated: one
float32 pass of the plain reference over a seeded batch sets its running
statistics to its input's and its weight to `BN_STD`, so that each
BatchNorm outputs mean 0 and std 0.1 on that batch and a change in the
last bit of the input moves nothing by more than rounding. The detect
head's box biases are warm-started (bins one-hot at 4 with value 4: the
program's `warm_start_detect_bias` rule). Its class biases are set where
the traffic asks for a number of detections an image (`Gate`): one logit
for every class, the least at which the reference's NMS at the traffic's
`conf` and `iou` keeps that many an image of the calibration batch on
average, so that a picture keeps about as many detections as a user's
would (tens a COCO photo, one or two an MRI slice). Otherwise they are
warm-started at logit 2, where every anchor clears the gate. The
decoder's output bias is centred on the median mask logit, so that masks
are neither empty nor full.

The state_dict made here is handed to the program and to the reference
alike; neither takes anything from the other.
"""

from __future__ import annotations

import contextlib
import re
from typing import Dict, Iterator, NamedTuple, Optional

import torch
from torch import nn

from .reference import nms as ref_nms
from .reference.yolo import BatchNorm, conv_modules, decode, set_fp8

BN_STD = 0.1
CLS_LOGIT, BOX_BIN, BOX_LOGIT = 2.0, 4, 4.0
CLS_BIAS = r"(^|\.)cv3\.\d+\.2\.bias$"


class Gate(NamedTuple):
    """The NMS a traffic mix runs, and the detections an image that the
    class bias is set to keep."""
    conf: float
    iou: float
    max_det: int
    per_image: float

    @classmethod
    def of(cls, traffic: dict) -> Optional["Gate"]:
        if "detections_per_image" not in traffic:
            return None
        return cls(traffic["conf"], traffic["iou"], traffic["max_det"],
                   traffic["detections_per_image"])


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on `device` for one of the run's random streams."""
    return torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + stream) % (2 ** 63))


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """float32 matmuls and convolutions without TF32, restored after."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def build(cls, *args, device: torch.device, **kw) -> nn.Module:
    """`cls(*args)` in inference mode with uninitialised storage on
    `device` (constructed on the meta device, so no host-side
    initialisation runs)."""
    with torch.device("meta"):
        model = cls(*args, **kw)
    return model.to_empty(device=device).eval()


@torch.no_grad()
def draw(model: nn.Module, seed: int) -> nn.Module:
    """Fill every parameter and buffer of `model` from `seed`: convolutions
    from one normal draw, BatchNorms at weight `BN_STD`, identity
    statistics, the DFL projection at arange(reg_max)."""
    device = next(model.parameters()).device
    convs = [(n, m) for n, m in conv_modules(model)
             if not n.endswith("dfl.conv")]
    total = sum(m.weight.numel() for _, m in convs)
    flat = torch.randn(total, generator=generator(seed, device, 0),
                       device=device)
    at = 0
    for _, m in convs:
        w = m.weight
        fan_in = (w.shape[0] * w[0, 0].numel()
                  if isinstance(m, nn.ConvTranspose2d) else w[0].numel())
        w.copy_(flat[at:at + w.numel()].view_as(w) * fan_in ** -0.5)
        at += w.numel()
        if m.bias is not None:
            m.bias.zero_()
    for name, m in model.named_modules():
        if isinstance(m, BatchNorm):
            m.weight.fill_(BN_STD)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
        elif name.endswith("dfl.conv"):
            m.weight.copy_(torch.arange(m.weight.numel(), dtype=torch.float32,
                                        device=device).view_as(m.weight))
    return model


@torch.no_grad()
def calibrate(model: nn.Module, run, bns) -> None:
    """Run `run()` once in exact float32 with the BatchNorms `bns` taking
    their input's statistics."""
    for bn in bns:
        bn.calibrating = True
    try:
        with exact_f32():
            run()
    finally:
        for bn in bns:
            bn.calibrating = False


@torch.no_grad()
def warm_start_head(model: nn.Module, reg_max: int = 16) -> None:
    for name, p in model.named_parameters():
        if re.search(CLS_BIAS, name):
            p.fill_(CLS_LOGIT)
        elif (re.search(r"(^|\.)cv2\.\d+\.2\.bias$", name)
              and p.shape[-1] == 4 * reg_max):
            p.zero_()
            p.view(4, reg_max)[:, BOX_BIN] = BOX_LOGIT


@torch.no_grad()
def gate_class_bias(yolo: nn.Module, calib: torch.Tensor, gate: Gate,
                    reg_max: int = 16, steps: int = 24) -> float:
    """Set every class bias of the reference detector `yolo` to the least
    logit at which NMS keeps `gate.per_image` detections an image of
    `calib` on average (bisection between -40 and 10). Returns it."""
    biases = [p for n, p in yolo.named_parameters() if re.search(CLS_BIAS, n)]
    for p in biases:
        p.zero_()
    with exact_f32():
        raw = yolo(calib)[0]
    box = 4 * reg_max

    def kept(b: float) -> float:
        shifted = [torch.cat([r[:, :box], r[:, box:] + b], 1) for r in raw]
        dets = ref_nms.nms(decode(shifted, yolo.nc), yolo.nc, gate.conf,
                           gate.iou, gate.max_det)
        return float(dets["valid"].sum()) / len(calib)

    lo, hi = -40.0, 10.0
    for _ in range(steps):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if kept(mid) >= gate.per_image else (mid, hi)
    for p in biases:
        p.fill_(hi)
    return hi


def batchnorms(model: nn.Module):
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


@torch.no_grad()
def detector_state(yolo: nn.Module, seed: int, calib: torch.Tensor,
                   gate: Optional[Gate] = None) -> None:
    """Seeded, calibrated, warm-started weights in the reference detector
    `yolo`, from the NCHW float32 batch `calib`; the class bias set for
    `gate` where one is given."""
    draw(yolo, seed)
    calibrate(yolo, lambda: yolo(calib), batchnorms(yolo))
    warm_start_head(yolo)
    if gate is not None:
        gate_class_bias(yolo, calib, gate)


@torch.no_grad()
def segpp_state(model: nn.Module, seed: int, calib: torch.Tensor,
                gate: Optional[Gate] = None) -> None:
    """The same for YOLO-Seg++: the detector first, then the decoder's
    BatchNorms at weight 1 calibrated in the fused pass, and the output
    bias centred on the median mask logit of `calib`."""
    draw(model, seed)
    calibrate(model.yolo, lambda: model.yolo(calib), batchnorms(model.yolo))
    warm_start_head(model.yolo)
    if gate is not None:
        gate_class_bias(model.yolo, calib, gate)
    dec = batchnorms(model.decoder)
    for bn in dec:
        bn.weight.fill_(1.0)
    model.eval()
    calibrate(model, lambda: model(calib), dec)
    with exact_f32():
        model.output.bias -= model(calib)[0].median()


def state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A detached copy of `model`'s state for the program to load."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def smooth_noise(gen: torch.Generator, shape, cells: int, device,
                 grain: float = 0.2) -> torch.Tensor:
    """(B, C, H, W) float32 in [0, 1]: uniform noise on a grid `cells`
    times coarser, bilinearly upsampled, plus a `grain` share of
    per-pixel noise: smooth structure at the image's own scale."""
    b, c, h, w = shape
    low = torch.rand((b, c, h // cells, w // cells), generator=gen,
                     device=device)
    x = torch.nn.functional.interpolate(low, size=(h, w), mode="bilinear",
                                        align_corners=False)
    fine = torch.rand(shape, generator=gen, device=device)
    return (x * (1.0 - grain) + fine * grain).clamp_(0.0, 1.0)


def lower_precision(ref: nn.Module, control: str) -> torch.dtype:
    """Put the reference `ref` in a configuration's control precision:
    "bfloat16" (below float32), or "fp8" (e4m3 operands, below bfloat16).
    Returns the dtype its input is to be cast to."""
    if control == "fp8":
        set_fp8(ref)
        return torch.bfloat16
    if control != "bfloat16":
        raise ValueError(f"unknown control precision {control!r}")
    return torch.bfloat16
