"""YOLO-format labelled dataset for detector / segmenter training.

Counterpart of `yolou_tpu/data/yolo_dataset.py`: image discovery, polygon
label parsing with a hashed npz cache, UNCHANGED-flag decode with channel
harmonisation, and collation into fixed-shape batches of uint8 images and
overlap-encoded instance id maps. Augmentation runs on the trainer's device
(`data/augment.py`); this module gives raw uint8 arrays only.

The validator's half: aspect-preserving rect items (`item_rect`), boxes from
instance masks, the padded collate and the rect grouping (`rect_groups`,
`rect_batch_shape`), and the `batches` iterator over them.

Files are decoded, resized and rasterised by `native/image.py`, which gives
what `cv2.imread`, `cv2.resize` and `cv2.fillPoly` give the JAX package, bit
for bit, without cv2: a PNG dataset needs no cv2. Not carried over: the
single-buffer packed collate (a workaround for a slow host link).
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, Iterator, List, Tuple

import numpy as np

from ..native.image import (IMREAD_GRAYSCALE, IMREAD_UNCHANGED, fill_poly,
                            imread, resize_linear, resize_nearest)

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
        flag = IMREAD_UNCHANGED if self.channels != 1 else IMREAD_GRAYSCALE
        img = imread(self.files[i], flag)
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
            img = resize_linear(img, (self.imgsz, self.imgsz))
            if img.ndim == 2:
                img = img[..., None]
        if self.cache_images:
            self._img_cache[i] = img
        return img

    def rasterize_instances(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-instance binary masks at imgsz: (n, S, S) uint8 + cls (n,)."""
        if self.cache_images and i in self._mask_cache:
            return self._mask_cache[i]
        s = self.imgsz
        items = self.labels[i]
        masks = np.zeros((len(items), s, s), np.uint8)
        cls = np.zeros((len(items),), np.int32)
        for j, (c, poly) in enumerate(items):
            cls[j] = c
            pts = np.round(poly * s).astype(np.int32)
            fill_poly(masks[j], [pts], 1)
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

    def item_rect(self, i: int, out_hw: Tuple[int, int]) -> Dict[str, np.ndarray]:
        """Aspect-preserving letterboxed item at a rect-group shape (long
        side resized, gray-114 padding, centred); instance masks rasterised
        in the letterboxed frame, so `boxes_from_masks` lands in out_hw
        pixels."""
        img0 = self.load_image_raw(i)
        h0, w0 = img0.shape[:2]
        oh, ow = out_hw
        gain = min(oh / h0, ow / w0)
        nh, nw = max(1, round(h0 * gain)), max(1, round(w0 * gain))
        resized = resize_linear(img0, (nw, nh))
        if resized.ndim == 2:
            resized = resized[..., None]
        canvas = np.full((oh, ow, img0.shape[2]), 114, img0.dtype)
        top, left = (oh - nh) // 2, (ow - nw) // 2
        canvas[top:top + nh, left:left + nw] = resized
        items = self.labels[i]
        masks = np.zeros((len(items), oh, ow), np.uint8)
        cls = np.zeros((len(items),), np.int32)
        for j, (c, poly) in enumerate(items):
            cls[j] = c
            pts = np.round(poly * np.array([w0, h0], np.float32) * gain
                           + np.array([left, top], np.float32)).astype(np.int32)
            fill_poly(masks[j], [pts], 1)
        return {"img": canvas, "masks": masks, "cls": cls,
                "path": self.files[i]}


def boxes_from_masks(masks: np.ndarray) -> np.ndarray:
    """(n, H, W) -> (n, 4) normalized xywh from mask extents."""
    n, h, w = masks.shape
    out = np.zeros((n, 4), np.float32)
    for i in range(n):
        ys, xs = np.nonzero(masks[i])
        if len(xs) == 0:
            continue
        x1, x2 = xs.min(), xs.max() + 1
        y1, y2 = ys.min(), ys.max() + 1
        out[i] = [(x1 + x2) / 2 / w, (y1 + y2) / 2 / h,
                  (x2 - x1) / w, (y2 - y1) / h]
    return out


def collate_padded(items: List[Dict[str, np.ndarray]], max_inst: int,
                   mask_ratio: int = 4) -> Dict[str, np.ndarray]:
    """Stack to fixed shapes: imgs (B,H,W,C) u8, cls (B,G), bboxes (B,G,4)
    xywh-norm, valid (B,G), masks (B,G,H/mr,W/mr) f32 (proto resolution).
    Works for square and rect (`item_rect`) items; all items in one batch
    must share a shape."""
    b = len(items)
    h, w, c = items[0]["img"].shape
    mh, mw = h // mask_ratio, w // mask_ratio
    imgs = np.zeros((b, h, w, c), np.uint8)
    cls = np.zeros((b, max_inst), np.int32)
    bboxes = np.zeros((b, max_inst, 4), np.float32)
    valid = np.zeros((b, max_inst), bool)
    masks = np.zeros((b, max_inst, mh, mw), np.float32)
    for i, it in enumerate(items):
        imgs[i] = it["img"]
        n = min(len(it["cls"]), max_inst)
        if n:
            cls[i, :n] = it["cls"][:n]
            m = it["masks"][:n]
            bboxes[i, :n] = boxes_from_masks(m)
            valid[i, :n] = m.reshape(n, -1).any(-1)
            for j in range(n):
                masks[i, j] = resize_nearest(m[j], (mh, mw))
    return {"img": imgs, "cls": cls, "bboxes": bboxes, "valid": valid,
            "masks": masks}


def rect_batch_shape(shapes: List[Tuple[int, int]], imgsz: int,
                     stride: int = 32, pad: float = 0.5) -> Tuple[int, int]:
    """Common letterbox shape for one rect group (ultralytics
    `set_rectangle` with the validation pad 0.5): scale each image's long
    side to imgsz, take the group max per dim, round up to a stride multiple
    with `pad` allowance."""
    hs, ws = [], []
    for h, w in shapes:
        g = imgsz / max(h, w)
        hs.append(h * g)
        ws.append(w * g)
    oh = int(np.ceil(max(hs) / stride + pad)) * stride
    ow = int(np.ceil(max(ws) / stride + pad)) * stride
    return oh, ow


def rect_groups(shapes: List[Tuple[int, int]], batch_size: int) -> List[List[int]]:
    """Aspect-ratio-sorted batch grouping (ultralytics rect mode): images
    sorted by h/w so each batch letterboxes to a similar shape."""
    ars = np.asarray([h / w for h, w in shapes])
    order = np.argsort(ars)
    return [list(map(int, order[i:i + batch_size]))
            for i in range(0, len(order), batch_size)]


def batches(ds: YoloSegDataset, batch_size: int, max_inst: int = 16,
            mask_ratio: int = 4, shuffle: bool = True, seed: int = 0,
            drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Padded batches of `ds.item`s in a seeded order; the tail is dropped or
    wrap-filled from the start of the same order."""
    idx = np.arange(len(ds))
    rng = np.random.default_rng(seed)
    if shuffle:
        rng.shuffle(idx)
    for start in range(0, len(idx), batch_size):
        chunk = idx[start:start + batch_size]
        if len(chunk) < batch_size:
            if drop_last:
                return
            chunk = np.concatenate([chunk, idx[: batch_size - len(chunk)]])
        yield collate_padded([ds.item(int(j)) for j in chunk], max_inst,
                             mask_ratio)


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
