"""Export command — the fused inference pipeline (letterbox -> forward ->
decode -> NMS) as a `torch.export` artifact directory (program.pt2 +
weights.msgpack + meta.json): the counterpart of the JAX package's
`cli/export.py`, over `engine/exporter.py`.

The program is traced on `--device` and runs there: a `torch.export`
program belongs to the device it was traced on, so the JAX command's
`--platforms` gives way to `--device`. `--stem-s2d`, the s2d(4)-input
program, is a TPU-only layout and is refused.

Example:
  python -m yolou_tpu_torch export --model best.ckpt --imgsz 640 \
      --batch 16 --out exported/ --bf16
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from ..engine.exporter import export_model, export_segpp
from ..utils.model_io import load_model
from .common import (add_device_argument, build_segpp_from_detector,
                     device_of, get_or_init_detector)


def main(argv=None):
    p = argparse.ArgumentParser(description="Export the fused inference "
                                "program to a torch.export artifact.")
    p.add_argument("--model", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--task", default="segment", choices=["detect", "segment"])
    p.add_argument("--kind", default="yolo", choices=["yolo", "segpp"],
                   help="segpp: export the fused e2e detector+decoder mask "
                        "program from a SegPP checkpoint")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--channels", type=int, default=4)
    p.add_argument("--conf", type=float, default=0.25)
    p.add_argument("--iou", type=float, default=0.45)
    p.add_argument("--max-det", type=int, default=300)
    p.add_argument("--platforms", default=None,
                   help="not ported: the program runs on --device")
    p.add_argument("--stem-s2d", action="store_true",
                   help="not ported: a TPU-only input layout")
    p.add_argument("--bf16", action="store_true")
    add_device_argument(p)
    args = p.parse_args(argv)

    if args.platforms is not None:
        raise NotImplementedError(
            "--platforms: a torch.export program runs on the device it was "
            "traced on; pass --device instead")
    if args.stem_s2d:
        raise NotImplementedError(
            "--stem-s2d: the s2d(4)-input program is a TPU-only layout and "
            "is not ported; export the plain uint8 program")
    device = device_of(args.device)
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    if args.kind == "segpp":
        if os.path.exists(args.model):
            model = load_model(args.model, dtype=dtype, device=device)
        else:  # fresh weights (smoke/testing path, like get_or_init_detector)
            det = get_or_init_detector(None, nc=1, ch=args.channels,
                                       task="detect", dtype=dtype,
                                       device=device)
            model = build_segpp_from_detector(det, nc=1, ch=args.channels,
                                              dtype=dtype, device=device)
        meta = export_segpp(
            model, args.out, imgsz=args.imgsz, batch=args.batch,
            channels=args.channels, conf=args.conf, iou=args.iou,
            max_det=args.max_det)
    else:
        model = get_or_init_detector(
            args.model, nc=1, ch=args.channels, task=args.task, dtype=dtype,
            device=device)
        meta = export_model(
            model, args.out, imgsz=args.imgsz, batch=args.batch,
            channels=args.channels, conf=args.conf, iou=args.iou,
            max_det=args.max_det)
    print(json.dumps(meta, indent=1))
    print(f"exported to {args.out}")
    return meta


if __name__ == "__main__":
    main()
