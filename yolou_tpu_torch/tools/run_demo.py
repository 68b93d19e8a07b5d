"""The four-stage training demo on the port: `tools/run_demo.sh` for
yolou_tpu_torch.

    python -m yolou_tpu_torch.tools.run_demo DIR [--device cuda]
        [--detector-epochs 120] [--decoder-epochs 120]

writes the synthetic BraTS-like set with `data/synthetic.py` (64 / 16 / 16
images at 160^2, seed 7: the JAX script's set, byte for byte), then runs
the JAX script's four stages as four `python -m yolou_tpu_torch`
processes with its flags: the detector fine-tune (batch 16, close mosaic
30, validation every 40 epochs), the objectmaps (batch 96), the decoder
(batch 16, lr 3e-4, early stopping from epoch 100) and the evaluation of
the test split. Between stages 2 and 3 it scores the objectmaps as the
script's inline Python does (`objectmap_auc`, without cv2). It prints each
stage's output as it comes and, last, one JSON line of outcomes: mAP50
and mAP50-95 at each validation, the objectmap AUC and fg / bg logit
means, the best validation Dice and its epoch, the test Dice, HD95,
precision and recall, each stage's wall seconds, each stage's kernel
launches (`kernels.launch_counts()` of its process) and the band attention
kernels' launches by path (`kernels.path_counts`). `run_demo`'s
keyword arguments shorten the run (schedules, set size, image size) for a
smoke test.
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np

from ..data.synthetic import generate
from ..native.image import IMREAD_GRAYSCALE, imread

# a stage: the command through the dispatcher, then its launch counts and
# kernels A and C's by path
_STAGE = ("import json, sys\n"
          "from yolou_tpu_torch import __main__ as cli, kernels\n"
          "out = cli.main(sys.argv[1:])\n"
          "print('kernel launches ' + json.dumps(kernels.launch_counts()))\n"
          "print('kernel paths ' + json.dumps({k: kernels.path_counts(k) "
          "for k in ('band_attention', 'band_attention_train')}))\n"
          "sys.exit(out if isinstance(out, int) else 0)\n")
_LAUNCHES = re.compile(r"^kernel launches (\{.*\})$", re.M)
_PATHS = re.compile(r"^kernel paths (\{.*\})$", re.M)
_VAL = re.compile(r"^epoch (\d+)/\d+ .*\| val mAP50=([0-9.na]+) "
                  r"mAP50-95=([0-9.na]+)", re.M)


def objectmap_auc(root: str) -> Dict[str, float]:
    """The fg / bg rank AUC of every `objectmap/<split>/<name>_20.npy`
    against its mask, as `tools/run_demo.sh` computes it: the mask read in
    gray and taken to the map's size by area averaging (cv2.INTER_AREA,
    which for a whole factor is the block mean, rounded to uint8), then
    > 127; the rank AUC over the map's values (ties ranked as numpy's
    argsort orders them). Means over the maps with both classes."""
    aucs, fg, bg = [], [], []
    for split in ("train", "val", "test"):
        om_dir = os.path.join(root, "objectmap", split)
        if not os.path.isdir(om_dir):
            continue
        for f in sorted(os.listdir(om_dir)):
            if not f.endswith("_20.npy"):
                continue
            om = np.load(os.path.join(om_dir, f))
            path = os.path.join(root, "masks", split,
                                f.replace("_20.npy", ".png"))
            if not os.path.exists(path):
                continue
            m = imread(path, IMREAD_GRAYSCALE)
            h, w = om.shape[:2]
            if m.shape[0] % h or m.shape[1] % w:
                raise ValueError(f"{path}: {m.shape} is not a whole multiple "
                                 f"of the map's {(h, w)}")
            blocks = m.reshape(h, m.shape[0] // h, w, m.shape[1] // w)
            mean = blocks.astype(np.float64).mean((1, 3))
            gt = np.floor(mean + 0.5).ravel() > 127     # cv2's rounding
            s = om.ravel()
            if gt.any() and (~gt).any():
                order = np.argsort(s)
                ranks = np.empty(len(s))
                ranks[order] = np.arange(len(s))
                aucs.append((ranks[gt].mean() - (gt.sum() - 1) / 2)
                            / (~gt).sum())
                fg.append(s[gt].mean())
                bg.append(s[~gt].mean())
    if not aucs:
        return {"auc": float("nan"), "fg_logit": float("nan"),
                "bg_logit": float("nan"), "n_maps": 0}
    return {"auc": float(np.mean(aucs)), "fg_logit": float(np.mean(fg)),
            "bg_logit": float(np.mean(bg)), "n_maps": len(aucs)}


def _run(name: str, argv: List[str], log_dir: str) -> Dict:
    """One stage as a process of its own, its output shown and kept in
    `<log_dir>/<name>.log`; raises where it fails."""
    print(f"=== {name}: python -m yolou_tpu_torch {' '.join(argv)} ===",
          flush=True)
    top = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [top] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    proc = subprocess.run([sys.executable, "-c", _STAGE, *argv],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True, env=env)
    seconds = time.time() - t0
    with open(os.path.join(log_dir, f"{name}.log"), "w") as f:
        f.write(proc.stdout)
    print(proc.stdout, end="", flush=True)
    if proc.returncode:
        raise RuntimeError(f"stage {name} exited with {proc.returncode}")
    launches = _LAUNCHES.findall(proc.stdout)
    paths = _PATHS.findall(proc.stdout)
    return {"seconds": seconds, "out": proc.stdout,
            "launches": json.loads(launches[-1]) if launches else None,
            "paths": json.loads(paths[-1]) if paths else None}


def _last_json(text: str) -> dict:
    """The last JSON object a command printed (evaluate's, indented)."""
    start = text.rindex("\n{\n") + 1 if "\n{\n" in text else text.index("{")
    return json.loads(text[start:text.index("\n}", start) + 2])


def _best_dice(run_dir: str) -> Dict[str, float]:
    """The best validation Dice of the decoder run's history.csv and its
    (1-based, first) epoch."""
    path = max(glob.glob(os.path.join(run_dir, "*", "history.csv")),
               key=os.path.getmtime)
    with open(path) as f:
        dice = [float(r["val_dice_metric"]) for r in csv.DictReader(f)]
    best = int(np.argmax(dice))
    return {"best_val_dice": dice[best], "best_val_dice_epoch": best + 1,
            "last_val_dice": dice[-1], "decoder_epochs_run": len(dice)}


def run_demo(root: str, device: str = "cuda", detector_epochs: int = 120,
             decoder_epochs: int = 120, close_mosaic: int = 30,
             val_every: int = 40, imgsz: int = 160, images=(64, 16, 16),
             batch: int = 16, objectmap_batch: int = 96) -> Dict:
    """Run the four stages in `root` (the set is written there first) and
    return the outcomes that `main` prints."""
    os.makedirs(root, exist_ok=True)
    log_dir = os.path.join(root, "logs")
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.time()
    yaml = generate(root, dict(zip(("train", "val", "test"), images)),
                    size=imgsz, seed=7)
    out: Dict = {"dataset_seconds": time.time() - t0, "device": device,
                 "imgsz": imgsz, "images": list(images)}
    det = os.path.join(root, "yolo_best.ckpt")
    dev = ["--device", device]
    stages = {}
    stages["train-detector"] = _run("train-detector", [
        "train-detector", "--data", yaml, "--imgsz", str(imgsz), "--batch",
        str(batch), "--epochs", str(detector_epochs), "--close-mosaic",
        str(close_mosaic), "--val-every", str(val_every), "--run-dir",
        os.path.join(root, "runs_det"), "--out", det, *dev], log_dir)
    stages["generate-objectmaps"] = _run("generate-objectmaps", [
        "generate-objectmaps", "--data_dir", root, "--yolo_dir", det,
        "--image_size", str(imgsz), "--batch_size", str(objectmap_batch),
        *dev], log_dir)
    out["objectmap"] = objectmap_auc(root)
    om = out["objectmap"]
    print(f"objectmap AUC mean={om['auc']:.3f} "
          f"fg_logit={om['fg_logit']:.2f} bg_logit={om['bg_logit']:.2f}",
          flush=True)
    dec_dir = os.path.join(root, "runs_dec")
    stages["train-decoder"] = _run("train-decoder", [
        "train-decoder", "--model", det, "--data", root, "--imgsz",
        str(imgsz), "--batch", str(batch), "--lr", "3e-4", "--epochs",
        str(decoder_epochs), "--early-stopping-start", "100", "--run-dir",
        dec_dir, *dev], log_dir)
    final = os.path.join(dec_dir, "segpp_final.ckpt")
    stages["evaluate"] = _run("evaluate", [
        "evaluate", "--model", final, "--yolo", det, "--data", root,
        "--split", "test", "--imgsz", str(imgsz), "--batch", str(batch),
        *dev], log_dir)
    out["validations"] = [
        {"epoch": int(e), "map50": float(a), "map": float(b)}
        for e, a, b in _VAL.findall(stages["train-detector"]["out"])]
    out.update(_best_dice(dec_dir))
    ev = _last_json(stages["evaluate"]["out"])
    out["test"] = {k: ev[k] for k in ("dice", "hd95", "precision", "recall",
                                      "n_images")}
    out["stage_seconds"] = {k: v["seconds"] for k, v in stages.items()}
    out["launches"] = {k: v["launches"] for k, v in stages.items()}
    out["paths"] = {k: v["paths"] for k, v in stages.items()}
    out["files"] = {"detector": det, "segpp": final}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m yolou_tpu_torch.tools.run_demo",
        description="tools/run_demo.sh on the port: synthetic set, detector "
                    "fine-tune, objectmaps, decoder, evaluation")
    ap.add_argument("root")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--detector-epochs", type=int, default=120)
    ap.add_argument("--decoder-epochs", type=int, default=120)
    args = ap.parse_args(argv)
    out = run_demo(args.root, args.device, args.detector_epochs,
                   args.decoder_epochs)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
