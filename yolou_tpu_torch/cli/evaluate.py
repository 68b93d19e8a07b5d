"""End-to-end evaluation command — Dice / HD95 / precision / recall of
YOLO-Seg++ over a split: the counterpart of the JAX package's
`cli/evaluate.py`, over `engine/evaluator.py::Evaluator`."""

from __future__ import annotations

import argparse
import json

import torch

from ..engine.evaluator import Evaluator
from ..utils.model_io import load_model
from .common import (add_device_argument, build_segpp_from_detector,
                     device_of, get_or_init_detector)


def main(argv=None):
    p = argparse.ArgumentParser(description="Evaluate YOLOSegPlusPlus end-to-end")
    p.add_argument("--model", default=None,
                   help="segpp checkpoint (kind=segpp); if absent, builds from "
                        "--yolo with a fresh decoder")
    p.add_argument("--yolo", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--data", default="data/stacked_segmentation")
    p.add_argument("--split", default="test")
    p.add_argument("--imgsz", type=int, default=160)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--no-hd95", action="store_true")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (default float32)")
    add_device_argument(p)
    args = p.parse_args(argv)

    device = device_of(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.model:
        model = load_model(args.model, dtype=dtype, device=device)
    else:
        det = get_or_init_detector(args.yolo, nc=1, ch=4, task="detect",
                                   device=device)
        model = build_segpp_from_detector(det, nc=1, ch=4, dtype=dtype,
                                          device=device)
    ev = Evaluator(model, args.data, image_size=args.imgsz,
                   batch_size=args.batch, device=device)
    metrics = ev.evaluate(args.split, with_hd95=not args.no_hd95)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main()
