"""Each plain reference against the program at a tiny size on the CPU
(where the program's kernels run their plain versions), float32: the same
seeded state_dict loads into both, strictly, and their outputs agree to
float32 rounding.

    python -m pytest benchmark/ -q
"""

from __future__ import annotations

import pytest
import torch

from benchmark import compare, weights
from benchmark.reference import nms as ref_nms
from benchmark.reference.segpp import SegPP
from benchmark.reference.yolo import YOLO

CPU = torch.device("cpu")


def close(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to float32 rounding at the tensor's own scale (at these tiny
    sizes a random network's logits reach the hundreds)."""
    return float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()) + 1e-6


def seeded_yolo(variant, nc, ch, task, size, seed=3):
    ref = weights.build(YOLO, variant, nc, ch, task, device=CPU)
    calib = weights.smooth_noise(weights.generator(seed, CPU, 1),
                                 (2, ch, size, size), 8, CPU)
    weights.detector_state(ref, seed, calib)
    return ref


@pytest.mark.parametrize("variant,task,nc,ch", [("n", "detect", 1, 4),
                                                ("n", "segment", 80, 3),
                                                ("s", "segment", 80, 3)])
def test_yolo_matches_the_program(variant, task, nc, ch):
    from yolou_tpu_torch.models.yolo import build_yolo
    ref = seeded_yolo(variant, nc, ch, task, 64)
    prog = build_yolo("yolov12", variant, nc, ch, task, device="cpu")
    prog.load_state_dict(weights.state_dict(ref), strict=True)
    x = weights.smooth_noise(weights.generator(9, CPU, 2), (2, ch, 64, 64),
                             8, CPU)
    with torch.no_grad():
        raw, preds, mc, protos, _ = ref(x)
        out = prog(x)
    for a, b in zip(out.raw, raw):
        assert close(a, b)
    # decoded boxes: a DFL softmax over logits in the hundreds (a random
    # network at 64^2) turns rounding of the logits into 1e-4 of a bin
    assert compare.channel_err([(out.preds, preds, -1)]) < 1e-4
    if task == "segment":
        assert close(out.protos, protos)
        assert close(out.mask_coefs, mc)


def test_segpp_matches_the_program():
    from yolou_tpu_torch.models.segpp import build_segpp
    ref = weights.build(SegPP, "n", 1, 4, "detect", device=CPU)
    x = weights.smooth_noise(weights.generator(4, CPU, 1), (3, 4, 64, 64), 8,
                             CPU)
    weights.segpp_state(ref, 4, x)
    prog = build_segpp("yolov12", "n", 1, 4, "detect", device="cpu")
    prog.load_state_dict(weights.state_dict(ref), strict=True)
    with torch.no_grad():
        mask, (raw, preds, _, _) = ref(x)
        pmask, out = prog(x)
        om = torch.rand(3, 1, 8, 8)
        enc_mask, _ = ref(x, om)
        penc_mask, _ = prog(x, om)
    assert close(pmask, mask)
    assert compare.channel_err([(out.preds, preds, -1)]) < 1e-4
    assert close(penc_mask, enc_mask)
    assert 0.2 < float((mask > 0).float().mean()) < 0.8


@pytest.mark.parametrize("nc", [1, 80])
def test_nms_matches_the_program(nc):
    """On the same predictions the reference's detections are the
    program's, value for value (its CPU path: the kernel's plain
    version)."""
    from yolou_tpu_torch.ops.nms import non_max_suppression
    ref = seeded_yolo("n", nc, 3, "segment", 64)
    x = weights.smooth_noise(weights.generator(5, CPU, 2), (3, 3, 64, 64),
                             8, CPU)
    with torch.no_grad():
        preds = ref(x)[1]
    prog = non_max_suppression(preds, nc=nc)
    mine = ref_nms.nms(preds, nc)
    for f in ("boxes", "conf", "cls", "extra", "valid"):
        assert torch.equal(getattr(prog, f), mine[f]), f
    assert int(mine["valid"].sum()) > 0


def test_letterbox_matches_the_program():
    from yolou_tpu_torch.ops.letterbox import letterbox_batch
    imgs = torch.randint(0, 256, (2, 48, 64, 3), dtype=torch.uint8)
    ref = ref_nms.letterbox(imgs, 64)
    prog = letterbox_batch(imgs, (64, 64)).permute(0, 3, 1, 2)
    assert torch.equal(ref, prog)


def test_weights_are_the_seeds():
    a = weights.state_dict(seeded_yolo("n", 1, 4, "detect", 32, seed=11))
    b = weights.state_dict(seeded_yolo("n", 1, 4, "detect", 32, seed=11))
    c = weights.state_dict(seeded_yolo("n", 1, 4, "detect", 32, seed=12))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    big = weights.generator(2 ** 31 + 12345, CPU, 0)
    assert torch.rand(1, generator=big).item() >= 0.0


@pytest.mark.parametrize("variant", ["m", "l", "x"])
def test_yolo_refuses_the_scales_it_does_not_write(variant):
    with pytest.raises(NotImplementedError):
        YOLO(variant, 80, 3, "segment")


def test_class_bias_keeps_the_gates_detections():
    """The class bias is the least at which NMS keeps the asked number a
    picture of the calibration batch: at it at least that many, a little
    below it fewer."""
    gate = weights.Gate(0.25, 0.45, 300, 6)
    ref = weights.build(YOLO, "n", 80, 3, "segment", device=CPU)
    calib = weights.smooth_noise(weights.generator(3, CPU, 1),
                                 (2, 3, 64, 64), 8, CPU)
    weights.detector_state(ref, 3, calib, gate)
    b = float(ref.model[-1].cv3[0][2].bias[0].detach())

    def kept(bias):
        for seq in ref.model[-1].cv3:
            seq[2].bias.data.fill_(bias)
        with torch.no_grad(), weights.exact_f32():
            preds = ref(calib)[1]
        return float(ref_nms.nms(preds, 80)["valid"].sum()) / 2
    assert kept(b) >= gate.per_image > kept(b - 0.05)
    assert gate == weights.Gate.of({"conf": 0.25, "iou": 0.45,
                                    "max_det": 300,
                                    "detections_per_image": 6})
    assert weights.Gate.of({"conf": 0.25}) is None
