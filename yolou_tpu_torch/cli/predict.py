"""Predict command — detection / segmentation over any source: the
counterpart of the JAX package's `cli/predict.py`, over
`engine/predictor.py::Predictor` (files, directories, globs, `.txt` lists,
PNG read without cv2; video files and stream URLs, a camera index and
`screen` through cv2, `mss` or PIL, each imported when such a source is
read).

`--save-dir` writes `detections.json`, and the annotated images through
`Results.save`, which draws with cv2: where cv2 is absent the command says
so before the model runs and writes the JSON only. `--stem-s2d` is the JAX
package's TPU layout rewrite; it is accepted and computes what the flag
off computes.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..engine.predictor import Predictor
from .common import add_device_argument, device_of, get_or_init_detector


def _have_cv2() -> bool:
    try:
        import cv2  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None):
    p = argparse.ArgumentParser(description="Run detection/segmentation "
                                "inference on images/dirs/globs/txt lists.")
    p.add_argument("--source", required=True,
                   help="file, dir, glob, txt list")
    p.add_argument("--model", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--task", default="segment", choices=["detect", "segment"])
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--retina-masks", action="store_true")
    p.add_argument("--stem-s2d", action="store_true",
                   help="accepted for the JAX package's command line; a TPU "
                        "layout rewrite that changes nothing here")
    p.add_argument("--save-dir", default=None,
                   help="write annotated images + a detections.json here")
    p.add_argument("--bf16", action="store_true")
    add_device_argument(p)
    args = p.parse_args(argv)

    draw = bool(args.save_dir) and _have_cv2()
    if args.save_dir and not draw:
        print(f"cv2 is not installed: {args.save_dir} gets detections.json "
              f"only, no annotated images")
    model = get_or_init_detector(
        args.model, nc=1, ch=args.channels, task=args.task,
        dtype=torch.bfloat16 if args.bf16 else torch.float32,
        device=device_of(args.device))
    pred = Predictor(model, imgsz=args.imgsz, channels=args.channels,
                     conf=args.conf, iou=args.iou, max_det=args.max_det,
                     batch_size=args.batch, retina_masks=args.retina_masks)
    results = pred(args.source)

    summary = []
    for r in results:
        n = len(r.boxes) if r.boxes is not None else 0
        summary.append({"path": r.path, "detections": n,
                        "conf": [float(c) for c in
                                 (r.boxes.conf.tolist() if n else [])]})
        print(f"{r.path}: {n} detection(s)")
        if draw:
            os.makedirs(args.save_dir, exist_ok=True)
            base = os.path.splitext(os.path.basename(str(r.path)))[0]
            base = base.replace("#", "_").replace("/", "_")
            r.save(os.path.join(args.save_dir, f"{base}_pred.png"))
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        with open(os.path.join(args.save_dir, "detections.json"), "w") as f:
            json.dump(summary, f, indent=1)
        print(f"saved {len(results) if draw else 0} annotated image(s) to "
              f"{args.save_dir}")
    return results


if __name__ == "__main__":
    main()
