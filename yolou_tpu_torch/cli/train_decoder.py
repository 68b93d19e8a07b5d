"""Decoder training command — the counterpart of the JAX package's
`cli/train_decoder.py` (the reference's `train.py` with its configuration
of record as defaults: imgsz 160, batch 128, lr 1e-4, 75 epochs, early stop
start 50 / patience 10, seed 42), over
`engine/trainer_decoder.py::DecoderTrainer`; the trained model is written
as `<run-dir>/segpp_final.ckpt`. A run writes `weights/best.ckpt` and
`last.ckpt` in the JAX trainer's layout, and `--resume` takes either
package's `last.ckpt` of a run over the same detector `--model`.
`--data-parallel N` trains in N ranks (one CUDA device each, or `--device
cpu` ranks), each update over the same global batch as one process's; rank
0 alone prints and writes files."""

from __future__ import annotations

import argparse
import os

import torch

from ..engine.trainer_decoder import DecoderTrainConfig, DecoderTrainer
from ..utils.model_io import save_model
from .common import (add_device_argument, build_segpp_from_detector,
                     device_of, get_or_init_detector, run_in_ranks)


def main(argv=None):
    p = argparse.ArgumentParser(description="Train the YOLOSegPlusPlus decoder")
    p.add_argument("--model", default="yolo_checkpoint/weights/best.ckpt",
                   help="detector checkpoint (fresh init if missing)")
    p.add_argument("--data", default="data/stacked_segmentation")
    p.add_argument("--imgsz", type=int, default=160)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=75)
    p.add_argument("--patience", type=int, default=10)
    p.add_argument("--early-stopping-start", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--no-logits", action="store_true",
                   help="ablation: decoder without the logits bottleneck")
    p.add_argument("--raw-objectmaps", action="store_true",
                   help="train on raw-sigmoid objectmaps (matched eval "
                        "conditioning) instead of the reference's z-scored "
                        "maps")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute (the reference's AMP)")
    p.add_argument("--run-dir", default="runs")
    p.add_argument("--data-parallel", type=int, default=0,
                   help="shard batches over N ranks, one device each (0 = "
                        "one process, no mesh)")
    p.add_argument("--resume", default=None,
                   help="a training-state last.ckpt of this package or of "
                        "the JAX package's train-decoder, over the same "
                        "encoder, to go on from")
    add_device_argument(p)
    args = p.parse_args(argv)
    return run_in_ranks(_train, args)


def _train(args, mesh):
    device = device_of(args.device) if mesh is None else mesh.device
    det = get_or_init_detector(args.model, nc=1, ch=4, task="detect",
                               seed=args.seed, device=device)
    model = build_segpp_from_detector(
        det, nc=1, ch=4, use_logits=not args.no_logits, seed=args.seed,
        dtype=torch.bfloat16 if args.bf16 else torch.float32, device=device)
    cfg = DecoderTrainConfig(
        image_size=args.imgsz, batch_size=args.batch, lr=args.lr,
        epochs=args.epochs, patience=args.patience,
        early_stopping_start=args.early_stopping_start, seed=args.seed,
        run_dir=args.run_dir, normalize_objectmap=not args.raw_objectmaps)
    trainer = DecoderTrainer(model, args.data, cfg, device=device, mesh=mesh)
    history = trainer.train(resume_from=args.resume)
    if trainer.is_main:
        save_model(os.path.join(args.run_dir, "segpp_final.ckpt"),
                   trainer.model)
    return history


if __name__ == "__main__":
    main()
