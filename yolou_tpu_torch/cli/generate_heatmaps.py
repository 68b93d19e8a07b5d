"""Heatmap generation command — the counterpart of the JAX package's
`cli/generate_heatmaps.py`: the Gaussian splat of each image's predicted
boxes, saved as `heatmap/<split>/<name>.png` (written without cv2)."""

from __future__ import annotations

import argparse

import torch

from ..engine.generate import generate_heatmaps
from ..engine.predictor import Predictor
from .common import add_device_argument, device_of, get_or_init_detector


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Generate Gaussian bbox heatmaps for every dataset split.")
    p.add_argument("--data_dir", default="data/stacked_segmentation")
    p.add_argument("--yolo_dir", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--out_dir", default=None)
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--confidence", type=float, default=0.25)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--workers", type=int, default=10, help="unused")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (default float32)")
    add_device_argument(p)
    args = p.parse_args(argv)

    model = get_or_init_detector(
        args.yolo_dir, nc=1, ch=4, task="detect",
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device_of(args.device))
    pred = Predictor(model, imgsz=args.image_size, channels=4,
                     conf=args.confidence, batch_size=min(args.batch_size, 64))
    counts = generate_heatmaps(pred, args.data_dir,
                               out_root=args.out_dir or args.data_dir,
                               size=args.image_size,
                               batch_size=args.batch_size)
    print(counts)
    return counts


if __name__ == "__main__":
    main()
