"""YOLO-format labelled dataset for detector / segmenter training.

Counterpart of `yolou_tpu/data/yolo_dataset.py`: image discovery, polygon
label parsing with a hashed npz cache, UNCHANGED-flag decode with channel
harmonisation, and collation into fixed-shape batches of uint8 images and
overlap-encoded instance id maps. Augmentation runs on the trainer's device
(`data/augment.py`); this module gives raw uint8 arrays only.

`cv2` decodes and rasterises; it is imported inside the methods that do so,
so that the trainer can be imported, and driven over in-memory batches, where
`cv2` is absent. Not carried over: the rect-batch items and padded collate
(the validator's, ported with it) and the single-buffer packed collate (a
workaround for a slow host link).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Tuple

import numpy as np

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def img2label_path(img_path: str) -> str:
    sa, sb = f"{os.sep}images{os.sep}", f"{os.sep}labels{os.sep}"
    base, _ = os.path.splitext(img_path)
    return base.replace(sa, sb) + ".txt"


def parse_label_file(path: str) -> List[Tuple[int, np.ndarray]]:
    """YOLO-seg rows: `cls x1 y1 x2 y2 ...` normalized polygon (or cls+xywh box)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) < 5:
                continue
            cls = int(float(vals[0]))
            coords = np.asarray([float(v) for v in vals[1:]], np.float32)
            if len(coords) == 4:  # xywh box -> rectangle polygon
                cx, cy, w, h = coords
                poly = np.asarray([[cx - w / 2, cy - h / 2], [cx + w / 2, cy - h / 2],
                                   [cx + w / 2, cy + h / 2], [cx - w / 2, cy + h / 2]],
                                  np.float32)
            else:
                poly = coords.reshape(-1, 2)
            out.append((cls, poly))
    return out


class YoloSegDataset:
    """Images + polygon instances, cached; items are (img_u8 HWC, cls (n,),
    polygons list) with polygons in normalized [0,1] coords."""

    def __init__(self, img_dir: str, imgsz: int = 160, channels: int = 4,
                 cache: bool = True, cache_images=False):
        self.img_dir = img_dir
        self.imgsz = imgsz
        self.channels = channels
        self.files = sorted(
            os.path.join(img_dir, f) for f in os.listdir(img_dir)
            if f.lower().endswith(IMG_EXTS))
        if not self.files:
            raise FileNotFoundError(f"no images in {img_dir}")
        self.labels = self._load_labels(cache)
        # image cache: True/"ram" decodes once into RAM; "disk" persists
        # decoded arrays as .npy next to the images
        self.cache_images = cache_images
        self.disk_cache = cache_images == "disk"
        self._img_cache: Dict[int, np.ndarray] = {}
        self._mask_cache: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._shape_cache: Dict[int, Tuple[int, int]] = {}
        self._idmap_cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def _cache_path(self) -> str:
        return os.path.join(self.img_dir, ".labels.cache.npz")

    def _hash(self) -> str:
        h = hashlib.sha1()
        for f in self.files:
            lp = img2label_path(f)
            h.update(f.encode())
            if os.path.exists(lp):
                h.update(str(os.path.getmtime(lp)).encode())
        return h.hexdigest()

    def _load_labels(self, cache: bool):
        cp = self._cache_path()
        want = self._hash()
        if cache and os.path.exists(cp):
            try:
                z = np.load(cp, allow_pickle=True)
                if str(z["hash"]) == want:
                    return list(z["labels"])
            except Exception:
                pass
        labels = [parse_label_file(img2label_path(f)) for f in self.files]
        if cache:
            try:
                np.savez(cp, hash=want,
                         labels=np.asarray(labels, dtype=object))
            except Exception:
                pass
        return labels

    def __len__(self):
        return len(self.files)

    def load_image_raw(self, i: int) -> np.ndarray:
        """Decode at original resolution (channels harmonized). With
        cache_images='disk', decoded arrays persist as `<image>.npy`."""
        npy = self.files[i] + ".npy"
        if self.disk_cache and os.path.exists(npy):
            try:
                return np.load(npy)
            except Exception:  # corrupt cache: re-decode
                os.remove(npy)
        import cv2
        flag = cv2.IMREAD_UNCHANGED if self.channels != 1 else cv2.IMREAD_GRAYSCALE
        img = cv2.imread(self.files[i], flag)
        if img is None:
            raise IOError(self.files[i])
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] != self.channels:
            # pad/trim channels (e.g. 3-ch source for a 4-ch model: repeat mean)
            if img.shape[2] < self.channels:
                extra = np.repeat(img.mean(-1, keepdims=True).astype(img.dtype),
                                  self.channels - img.shape[2], axis=-1)
                img = np.concatenate([img, extra], -1)
            else:
                img = img[..., : self.channels]
        if self.disk_cache:
            try:
                np.save(npy, img)
            except Exception:
                pass
        return img

    def orig_shape(self, i: int) -> Tuple[int, int]:
        if i not in self._shape_cache:
            self._shape_cache[i] = tuple(self.load_image_raw(i).shape[:2])
        return self._shape_cache[i]

    def load_image(self, i: int) -> np.ndarray:
        if self.cache_images and i in self._img_cache:
            return self._img_cache[i]
        img = self.load_image_raw(i)
        if img.shape[:2] != (self.imgsz, self.imgsz):
            import cv2
            img = cv2.resize(img, (self.imgsz, self.imgsz),
                             interpolation=cv2.INTER_LINEAR)
            if img.ndim == 2:
                img = img[..., None]
        if self.cache_images:
            self._img_cache[i] = img
        return img

    def rasterize_instances(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-instance binary masks at imgsz: (n, S, S) uint8 + cls (n,)."""
        if self.cache_images and i in self._mask_cache:
            return self._mask_cache[i]
        import cv2
        s = self.imgsz
        items = self.labels[i]
        masks = np.zeros((len(items), s, s), np.uint8)
        cls = np.zeros((len(items),), np.int32)
        for j, (c, poly) in enumerate(items):
            cls[j] = c
            pts = np.round(poly * s).astype(np.int32)
            cv2.fillPoly(masks[j], [pts], 1)
        if self.cache_images:
            self._mask_cache[i] = (masks, cls)
        return masks, cls

    def item(self, i: int) -> Dict[str, np.ndarray]:
        img = self.load_image(i)
        masks, cls = self.rasterize_instances(i)
        return {"img": img, "masks": masks, "cls": cls,
                "path": self.files[i]}

    def item_idmap(self, i: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Overlap-encoded instance id map for image i, cached.

        Returns (idmap (S,S) uint8|int32, cls (n,) i32, valid (n,) bool) with
        instances ordered largest-area-first so smaller instances overwrite
        (ultralytics overlap_mask ordering — same encoding collate_idmap
        produces, but computed once per image)."""
        if self.cache_images and i in self._idmap_cache:
            return self._idmap_cache[i]
        masks, cls = self.rasterize_instances(i)
        n = len(cls)
        s = self.imgsz
        idmap = np.zeros((s, s), np.uint8 if n < 255 else np.int32)
        ocls = np.zeros((n,), np.int32)
        ovalid = np.zeros((n,), bool)
        if n:
            areas = masks.reshape(n, -1).sum(-1)
            order = np.argsort(-areas)
            for slot, j in enumerate(order):
                idmap[masks[j] > 0] = slot + 1
                ocls[slot] = cls[j]
                ovalid[slot] = areas[j] > 0
        out = (idmap, ocls, ovalid)
        if self.cache_images:
            self._idmap_cache[i] = out
        return out


def collate_idmap(items: List[Dict[str, np.ndarray]], max_inst: int) -> Dict[str, np.ndarray]:
    """Collate for the device augmentation path: overlap-encoded id maps.

    Instances are written largest-area first so smaller ones overwrite
    (ultralytics overlap_mask ordering). Returns img (B,S,S,C) u8,
    idmap (B,S,S) i32, cls (B,G) i32, valid (B,G) bool.
    """
    b = len(items)
    s = items[0]["img"].shape[0]
    c = items[0]["img"].shape[2]
    imgs = np.zeros((b, s, s, c), np.uint8)
    idmap = np.zeros((b, s, s), np.int32)
    cls = np.zeros((b, max_inst), np.int32)
    valid = np.zeros((b, max_inst), bool)
    for i, it in enumerate(items):
        imgs[i] = it["img"]
        m = it["masks"]
        n = min(len(it["cls"]), max_inst)
        if n == 0:
            continue
        areas = m[:n].reshape(n, -1).sum(-1)
        order = np.argsort(-areas)
        for slot, j in enumerate(order):
            idmap[i][m[j] > 0] = slot + 1
            cls[i, slot] = it["cls"][j]
            valid[i, slot] = areas[j] > 0
    return {"img": imgs, "idmap": idmap, "cls": cls, "valid": valid}


def collate_idmap_cached(ds: YoloSegDataset, sel,
                         max_inst: int) -> Dict[str, np.ndarray]:
    """collate_idmap over dataset indices via the per-image caches.

    The hot path is pure memcpy stacking (image + precomputed idmap); the id
    map ships as uint8 when max_inst allows (a quarter of the host-to-device
    bytes; the train step widens it on the device). Semantically identical
    to `collate_idmap([ds.item(j) for j in sel], max_inst)`."""
    b = len(sel)
    s = ds.imgsz
    u8 = max_inst < 256
    imgs = np.empty((b, s, s, ds.channels), np.uint8)
    idmap = np.zeros((b, s, s), np.uint8 if u8 else np.int32)
    cls = np.zeros((b, max_inst), np.int32)
    valid = np.zeros((b, max_inst), bool)
    for i, j in enumerate(sel):
        j = int(j)
        imgs[i] = ds.load_image(j)
        im, c, v = ds.item_idmap(j)
        n = len(c)
        if n > max_inst:  # zero slots beyond the instance budget
            im = np.where(im <= max_inst, im, 0)
            n = max_inst
        idmap[i] = im
        cls[i, :n] = c[:n]
        valid[i, :n] = v[:n]
    return {"img": imgs, "idmap": idmap, "cls": cls, "valid": valid}
