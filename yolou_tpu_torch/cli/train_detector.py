"""Detector fine-tune command — the counterpart of the JAX package's
`cli/train_detector.py`, over `engine/trainer_detector.py::DetectorTrainer`;
the EMA weights are written as a `.ckpt` model file at the end.
`--data-parallel N` trains in N ranks (one CUDA device each, or `--device
cpu` ranks), each step over the same global batch as one process's; rank 0
alone prints and writes files. A run
writes `weights/last.ckpt` and `best.ckpt` in the JAX trainer's layout, and
`--resume` takes either package's `last.ckpt` (the JAX command's default
flat-vector state too):

  python -m yolou_tpu train-detector --data d.yaml --epochs 3 --run-dir r
  python -m yolou_tpu_torch train-detector --data d.yaml --epochs 4 \
      --resume r/<run>/weights/last.ckpt
"""

from __future__ import annotations

import argparse

import torch

from ..data.config import load_data_yaml
from ..engine.trainer_detector import DetectorTrainConfig, DetectorTrainer
from ..utils.model_io import save_model
from .common import (add_device_argument, device_of, get_or_init_detector,
                     run_in_ranks)


def main(argv=None):
    p = argparse.ArgumentParser(description="Train/fine-tune the YOLOv12 det/seg model")
    p.add_argument("--data", default="data/data.yaml")
    p.add_argument("--model", default=None, help="initial weights (optional)")
    p.add_argument("--task", default="segment", choices=["detect", "segment"])
    p.add_argument("--variant", default="n")
    p.add_argument("--imgsz", type=int, default=160)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr0", type=float, default=0.01)
    p.add_argument("--optimizer", default="sgd", choices=["sgd", "adamw"])
    p.add_argument("--close-mosaic", type=int, default=10)
    p.add_argument("--val-every", type=int, default=0,
                   help="mAP on val every N epochs (0 = off)")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="train in N ranks, one device each (0 = one "
                        "process, no mesh)")
    p.add_argument("--run-dir", default="runs_detector")
    p.add_argument("--out", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--resume", default=None,
                   help="a training-state last.ckpt of this package or of "
                        "the JAX package's train-detector (tree or flat "
                        "form) to go on from")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="compute dtype (parameters stay float32)")
    p.add_argument("--pallas", action="store_true",
                   help="accepted for the JAX package's command line; the "
                        "CUDA kernels are always the route here")
    add_device_argument(p)
    args = p.parse_args(argv)
    return run_in_ranks(_train, args)


def _train(args, mesh):
    device = device_of(args.device) if mesh is None else mesh.device
    data_cfg = load_data_yaml(args.data)
    model = get_or_init_detector(
        args.model, variant=args.variant, nc=data_cfg.nc,
        ch=data_cfg.channels, task=args.task,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        device=device)
    cfg = DetectorTrainConfig(
        imgsz=args.imgsz, batch_size=args.batch, epochs=args.epochs,
        lr0=args.lr0, optimizer=args.optimizer,
        close_mosaic=args.close_mosaic, run_dir=args.run_dir,
        val_every=args.val_every)
    trainer = DetectorTrainer(model, data_cfg, cfg, device=device, mesh=mesh)
    history = trainer.train(resume_from=args.resume)
    if trainer.is_main:
        save_model(args.out, trainer.model,
                   state_dict=trainer.ema_variables())
        print(f"saved EMA weights to {args.out}")
    return history


if __name__ == "__main__":
    main()
