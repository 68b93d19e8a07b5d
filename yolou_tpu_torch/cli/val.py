"""Validation command — detector mAP50 / mAP50-95 / precision / recall over
a split: the counterpart of the JAX package's `cli/val.py`, over
`engine/validator.py::validate_detector` (rect mode included). The split's
PNGs are read without cv2."""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..data.config import load_data_yaml
from ..engine.validator import validate_detector
from .common import add_device_argument, device_of, get_or_init_detector


def main(argv=None):
    p = argparse.ArgumentParser(description="Validate a detector checkpoint: "
                                "mAP50 / mAP50-95 / precision / recall.")
    p.add_argument("--data", required=True,
                   help="data.yaml or a directory of images with labels/")
    p.add_argument("--split", default="val", choices=["train", "val", "test"])
    p.add_argument("--model", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--task", default="segment", choices=["detect", "segment"])
    p.add_argument("--imgsz", type=int, default=160)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--rect", action="store_true",
                   help="rect-mode val: aspect-ratio-grouped letterbox batches")
    p.add_argument("--out", default=None, help="optional metrics JSON path")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (default float32)")
    add_device_argument(p)
    args = p.parse_args(argv)

    if args.data.endswith((".yaml", ".yml")):
        cfg = load_data_yaml(args.data)
        img_dir = cfg.split_dir(args.split)
        args.channels = cfg.channels
        nc = cfg.nc
    else:
        nc = 1
        img_dir = os.path.join(args.data, "images", args.split)
        if not os.path.isdir(img_dir):
            img_dir = args.data

    model = get_or_init_detector(
        args.model, nc=nc, ch=args.channels, task=args.task,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device_of(args.device))
    metrics = validate_detector(
        model, None, img_dir, imgsz=args.imgsz, channels=args.channels,
        batch_size=args.batch, conf=args.conf, iou=args.iou,
        max_det=args.max_det, rect=args.rect)
    print(json.dumps(metrics, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=1)
    return metrics


if __name__ == "__main__":
    main()
