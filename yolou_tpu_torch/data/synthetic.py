"""Synthetic BraTS-like dataset generator.

The port's own copy of `yolou_tpu/data/synthetic.py`: for the same seed it
writes the same files, byte for byte. The layout is the reference's
(images/<split>/*.png 4-channel, masks/<split> binary PNGs,
objectmap/<split>/*_20.npy, YOLO-seg polygon labels labels/<split>/*.txt and
a data.yaml), so every stage (decoder training, detector training,
evaluation, objectmap generation) runs without the real dataset. cv2 is
imported inside the functions that draw and write, so the module imports
where cv2 is absent.
"""

from __future__ import annotations

import os

import numpy as np


def _blob_mask(rng, size, max_blobs=2):
    import cv2
    mask = np.zeros((size, size), np.uint8)
    for _ in range(rng.integers(0, max_blobs + 1)):
        cy, cx = rng.integers(size // 4, 3 * size // 4, 2)
        ry, rx = rng.integers(size // 12, size // 5, 2)
        ang = rng.integers(0, 180)
        cv2.ellipse(mask, (int(cx), int(cy)), (int(rx), int(ry)), int(ang),
                    0, 360, 1, -1)
    return mask


def _polygons_from_mask(mask):
    import cv2
    cnts, _ = cv2.findContours(mask, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    polys = []
    for c in cnts:
        if cv2.contourArea(c) < 9:
            continue
        polys.append(c.reshape(-1, 2).astype(np.float32))
    return polys


def generate(root: str, n_per_split=None, size: int = 160, seed: int = 0,
             channels: int = 4) -> str:
    """Create the dataset under `root`; returns path to data.yaml."""
    import cv2

    n_per_split = n_per_split or {"train": 16, "val": 8, "test": 8}
    rng = np.random.default_rng(seed)
    for split, n in n_per_split.items():
        img_dir = os.path.join(root, "images", split)
        msk_dir = os.path.join(root, "masks", split)
        lbl_dir = os.path.join(root, "labels", split)
        for d in (img_dir, msk_dir, lbl_dir):
            os.makedirs(d, exist_ok=True)
        for i in range(n):
            name = f"{split}_{i:04d}"
            mask = _blob_mask(rng, size)
            img = (rng.normal(0.35, 0.12, (size, size, channels)) * 255)
            bg = cv2.GaussianBlur(rng.random((size, size)).astype(np.float32),
                                  (0, 0), size / 10)
            img += (bg[..., None] * 60)
            img[mask > 0] += rng.uniform(40, 90)
            img = np.clip(img, 0, 255).astype(np.uint8)
            cv2.imwrite(os.path.join(img_dir, name + ".png"), img)
            cv2.imwrite(os.path.join(msk_dir, name + ".png"), mask * 255)
            with open(os.path.join(lbl_dir, name + ".txt"), "w") as f:
                for poly in _polygons_from_mask(mask):
                    coords = (poly / size).reshape(-1)
                    f.write("0 " + " ".join(f"{c:.6f}" for c in coords) + "\n")
    yaml_path = os.path.join(root, "data.yaml")
    with open(yaml_path, "w") as f:
        f.write(f"path: {root}\ntrain: images/train\nval: images/val\n"
                f"test: images/test\nchannels: {channels}\nnc: 1\n"
                f'names: ["whole_tumor"]\n')
    return yaml_path


def write_objectmaps(root: str, maps_by_name, split: str) -> None:
    """Save raw-logit objectmaps as `<name>_20.npy` (the decoder dataset also
    reads the reference's `.pt` files)."""
    out = os.path.join(root, "objectmap", split)
    os.makedirs(out, exist_ok=True)
    for name, arr in maps_by_name.items():
        np.save(os.path.join(out, f"{name}_20.npy"), np.asarray(arr, np.float32))
