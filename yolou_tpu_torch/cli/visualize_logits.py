"""Logit-map visualization command — the counterpart of the JAX package's
`cli/visualize_logits.py`: the sigmoid of the detector's stride-8 class-logit
map (20x20 at 160^2) for one image, its confidence statistics, and a plot
of the image beside the map (saved with `--out`, else shown) where
matplotlib is installed; without it the command prints why the plot was
skipped, as the JAX command does. Returns the probabilities."""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..engine.generate import argmax_confidence, spatial_confidence
from ..engine.predictor import Predictor, load_source
from .common import add_device_argument, device_of, get_or_init_detector


def main(argv=None):
    p = argparse.ArgumentParser(description="Visualize detector logit maps")
    p.add_argument("image")
    p.add_argument("--yolo_dir", default="yolo_checkpoint/weights/best.ckpt")
    p.add_argument("--image_size", type=int, default=160)
    p.add_argument("--out", default=None, help="save PNG instead of showing")
    add_device_argument(p)
    args = p.parse_args(argv)

    model = get_or_init_detector(args.yolo_dir, nc=1, ch=4, task="detect",
                                 dtype=torch.float32,
                                 device=device_of(args.device))
    pred = Predictor(model, imgsz=args.image_size, channels=4, batch_size=1)
    (_, img), = load_source(args.image, channels=4)
    out = pred.raw_forward(img[None])
    # the last (class-logit) channel of the stride-8 map, NCHW here
    logits = out.raw[0][0, -1].float().cpu().numpy()
    probs = 1 / (1 + np.exp(-logits))
    print(f"spatial_confidence(top20%)={spatial_confidence(logits):.4f}")
    print(f"argmax_confidence={argmax_confidence(logits):.4f}")

    try:
        import matplotlib
        matplotlib.use("Agg" if args.out else matplotlib.get_backend())
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(9, 4))
        axes[0].imshow(img[..., :3][..., ::-1])
        axes[0].set_title(os.path.basename(args.image))
        im = axes[1].imshow(probs, cmap="viridis")
        axes[1].set_title("sigmoid(P3 class logits) 20x20")
        fig.colorbar(im, ax=axes[1])
        if args.out:
            fig.savefig(args.out, dpi=120)
            print(f"saved {args.out}")
        else:
            plt.show()
        plt.close(fig)
    except Exception as e:  # headless-safe, and where matplotlib is absent
        print(f"(plot skipped: {e})")
    return probs


if __name__ == "__main__":
    main()
