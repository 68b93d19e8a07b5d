"""Faults planted underneath the timed path, to show that `correct` comes
out false: the benchmark's own tests plant them at a tiny size on the CPU,
and `python3 -m benchmark.control --fault <name>` reads them on the card
at a cell's own size (a training cell's limit needs those readings). The
benchmark's runs never plant one.

- `half_batch`: the model computes the first half of the batch only and
  gives its outputs for the second half too (inference); the training
  step takes the first half of the batch, its loss the mean over it;
- `altered_answer`: NMS moves one detection's score by 1e-3;
- `unchanged`: the training step returns its state unchanged (AdamW's
  update skipped).
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


def _half_forward(forward):
    def broken(self, x, *args, **kw):
        h = (len(x) + 1) // 2
        out = forward(self, x[:h], *args, **kw)

        def twice(t):
            return (torch.cat([t, t], 0)[:len(x)]
                    if torch.is_tensor(t) and t.dim() and len(t) == h else t)
        mask, yo = out if isinstance(out, tuple) else (None, out)
        yo.preds, yo.protos = twice(yo.preds), twice(yo.protos)
        return (twice(mask), yo) if isinstance(out, tuple) else yo
    return broken


def _half_step(step):
    def broken(self, img, mask, om):
        h = len(img) // 2
        return step(self, img[:h], mask[:h], om[:h])
    return broken


def _altered(nms):
    def broken(*args, **kw):
        res = nms(*args, **kw)
        res.conf[0, 0] += 1e-3
        return res
    return broken


@contextlib.contextmanager
def planted(name: str, driver: str) -> Iterator[None]:
    """Plant fault `name` in the program's entry that traffic driver
    `driver` calls, for the duration of the block."""
    from yolou_tpu_torch.engine import evaluator, predictor, trainer_decoder
    from yolou_tpu_torch.models.segpp import YOLOSegPP
    from yolou_tpu_torch.models.yolo import YOLOModel
    targets = {
        ("half_batch", "evaluator_volume"): (YOLOSegPP, "forward",
                                             _half_forward),
        ("half_batch", "predictor_batch"): (YOLOModel, "forward",
                                            _half_forward),
        ("half_batch", "decoder_train"): (trainer_decoder.DecoderTrainer,
                                          "step", _half_step),
        ("altered_answer", "evaluator_volume"): (
            evaluator, "non_max_suppression", _altered),
        ("altered_answer", "predictor_batch"): (
            predictor, "non_max_suppression", _altered),
        ("unchanged", "decoder_train"): (
            torch.optim.AdamW, "step", lambda step: lambda self, *a, **k: None),
    }
    owner, attr, make = targets[(name, driver)]
    original = getattr(owner, attr)
    setattr(owner, attr, make(original))
    try:
        yield
    finally:
        setattr(owner, attr, original)
