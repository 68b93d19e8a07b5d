"""Decoder-stage dataset: (4-ch image, mask, objectmap) triplets.

The port's own copy of `yolou_tpu/data/decoder_dataset.py` (numpy only, so
that this package imports nothing of the JAX package): cv2 UNCHANGED
4-channel decode, bilinear image / nearest mask resize, /255, objectmap
z-score-then-sigmoid normalization (the training-side conditioning; the
fused evaluation pass uses a raw sigmoid instead).

Batches come out as stacked NHWC numpy arrays ready for upload; an optional
background prefetch thread overlaps decode with device compute. `cv2` is
imported inside the method that decodes, so the module imports, and batches
held in memory can be evaluated, where `cv2` is absent.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Tuple

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def load_objectmap(path_base: str) -> np.ndarray:
    """Load `<base>_20.npy` or `<base>_20.pt` -> (20, 20) float32 raw logits."""
    npy = path_base + "_20.npy"
    if os.path.exists(npy):
        arr = np.load(npy)
    else:
        import torch  # the reference saved these with torch.save
        arr = torch.load(path_base + "_20.pt", map_location="cpu",
                         weights_only=True).numpy()
    return np.asarray(arr, np.float32).reshape(arr.shape[-2], arr.shape[-1])


def condition_objectmap(om: np.ndarray, normalize: bool = True
                        ) -> np.ndarray:
    """A raw objectmap (h, w) -> the decoder's conditioning input (h, w, 1)
    f32: the sigmoid of its per-image z-score (`normalize`), else of the raw
    logits."""
    if normalize:
        # the reference's torch.Tensor.std() is UNBIASED (ddof=1):
        # bit-exact conditioning needs that divisor
        mu, sd = om.mean(), om.std(ddof=1)
        om = (om - mu) / sd if sd > 0 else om - mu
    return _sigmoid(om)[..., None].astype(np.float32)


class DecoderDataset:
    def __init__(self, root_path: str, image_path: str, mask_path: str,
                 image_size: int, objectmap_path: Optional[str] = None,
                 normalize_objectmap: bool = True, subsample: float = 1.0,
                 cache_images: bool = True):
        self.image_dir = os.path.join(root_path, image_path)
        self.mask_dir = os.path.join(root_path, mask_path)
        self.objectmap_dir = (os.path.join(root_path, objectmap_path)
                              if objectmap_path else None)
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
        names = sorted(n for n in os.listdir(self.image_dir)
                       if n.lower().endswith(exts) and not n.startswith("."))
        self.basenames = [os.path.splitext(n)[0] for n in names]
        self.basenames = self.basenames[: int(len(self.basenames) * subsample)]
        for b in self.basenames:
            if not os.path.exists(os.path.join(self.mask_dir, b + ".png")):
                raise FileNotFoundError(f"mask not found for {b}")
        self.image_size = image_size
        self.normalize_objectmap = normalize_objectmap
        # decoded-triplet RAM cache: ~130 KB/item u8 fits RAM easily and
        # saves re-decoding the PNGs every epoch
        self.cache_images = cache_images
        self._cache: dict = {}

    def __len__(self) -> int:
        return len(self.basenames)

    def item_u8(self, i: int):
        """(img_u8 (S,S,C), mask_u8 (S,S,1), om_f32 (20,20,1)|None), cached.

        cv2.resize runs on the uint8 arrays (as in the reference, which
        resizes BEFORE the /255), so the uint8 cache and an on-device /255
        reproduce __getitem__ bit-exactly."""
        if self.cache_images and i in self._cache:
            return self._cache[i]
        import cv2
        b = self.basenames[i]
        img = cv2.imread(os.path.join(self.image_dir, b + ".png"),
                         cv2.IMREAD_UNCHANGED)
        if img.ndim == 2:
            img = img[..., None]
        mask = cv2.imread(os.path.join(self.mask_dir, b + ".png"),
                          cv2.IMREAD_GRAYSCALE)
        s = self.image_size
        img = cv2.resize(img, (s, s), interpolation=cv2.INTER_LINEAR)
        if img.ndim == 2:
            img = img[..., None]
        mask = cv2.resize(mask, (s, s), interpolation=cv2.INTER_NEAREST)
        om = None
        if self.objectmap_dir is not None:
            om = condition_objectmap(
                load_objectmap(os.path.join(self.objectmap_dir, b)),
                self.normalize_objectmap)
        out = (img, mask[..., None], om)
        if self.cache_images:
            self._cache[i] = out
        return out

    def __getitem__(self, i: int):
        img, mask, om = self.item_u8(i)
        return (img.astype(np.float32) / 255.0,
                mask.astype(np.float32) / 255.0, om)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = False,
                u8: bool = False) -> Iterator[Tuple[np.ndarray, ...]]:
        """Yield stacked (imgs, masks, objectmaps) NHWC batches.

        The last partial batch is padded by repeating its first element up to
        batch_size (one batch shape throughout) with `n_real` returned via the
        fourth element. With u8=True imgs/masks stay uint8 (4x less
        host->device traffic; the consumer does the /255 on device —
        bit-exact, see item_u8).
        """
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(idx)
        for start in range(0, len(idx), batch_size):
            chunk = idx[start:start + batch_size]
            n_real = len(chunk)
            if n_real < batch_size:
                if drop_last:
                    return
                chunk = np.concatenate([chunk, np.full(batch_size - n_real,
                                                       chunk[0])])
            items = [(self.item_u8 if u8 else self.__getitem__)(int(j))
                     for j in chunk]
            imgs = np.stack([it[0] for it in items])
            masks = np.stack([it[1] for it in items])
            oms = (np.stack([it[2] for it in items])
                   if items[0][2] is not None else None)
            yield imgs, masks, oms, n_real


def prefetch(it: Iterator, depth: int = 2) -> Iterator:
    """Background-thread prefetch of any iterator (DataLoader-worker stand-in)."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in it:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
