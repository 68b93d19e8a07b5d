"""PyTorch port: the PNG kinds the package's own decoder does not read
(16-bit, palette, interlaced) read as the JAX package reads them, through
cv2.

Each kind is written here (cv2 for 16-bit, PIL for palette, an Adam7
interlaced file assembled scanline by scanline), in gray and colour forms.
`native.image.imread` must give what `cv2.imread` gives under
IMREAD_UNCHANGED and IMREAD_GRAYSCALE, array and dtype, and a synthetic
dataset whose images are replaced by these files must give the JAX
`YoloSegDataset`'s decoded images and items exactly. Where cv2 is absent
`imread` names the file and its kind (`test_torch_port_image_io.py`).
"""

import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from yolou_tpu.data import synthetic as jax_synthetic
from yolou_tpu.data import yolo_dataset as jds
from yolou_tpu_torch.data import yolo_dataset as tds
from yolou_tpu_torch.native import image, loader

from .torch_threads import one_torch_thread  # noqa: F401

SIZE = 32
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_interlaced(path: str, rgb_or_gray: np.ndarray) -> None:
    """An 8-bit Adam7 PNG of (H, W) gray or (H, W, 3|4) RGB(A) pixels:
    each pass's scanlines with filter 0."""
    a = rgb_or_gray if rgb_or_gray.ndim == 3 else rgb_or_gray[..., None]
    h, w, c = a.shape
    raw = bytearray()
    for x0, y0, dx, dy in ADAM7:
        sub = a[y0::dy, x0::dx]
        if sub.size:
            for row in sub:
                raw += b"\x00" + row.tobytes()
    ctype = {1: 0, 3: 2, 4: 6}[c]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype,
                                              0, 0, 1))
                + _chunk(b"IDAT", zlib.compress(bytes(raw)))
                + _chunk(b"IEND", b""))


def write_kind(path: str, kind: str, seed: int) -> None:
    rng = np.random.default_rng(seed)
    if kind.startswith("16-bit"):
        c = 4 if kind.endswith("bgra") else 1
        px = rng.integers(0, 65536, (SIZE, SIZE, c), dtype=np.uint16)
        assert cv2.imwrite(path, px if c > 1 else px[..., 0])
    elif kind.startswith("palette"):
        idx = rng.integers(0, 40, (SIZE, SIZE), dtype=np.uint8)
        im = Image.fromarray(idx, mode="P")
        im.putpalette(rng.integers(0, 256, 40 * 3).astype(np.uint8).tolist())
        if kind.endswith("alpha"):
            im.info["transparency"] = bytes(
                rng.integers(0, 256, 40, dtype=np.uint8))
        im.save(path, transparency=im.info.get("transparency"))
    else:
        c = {"interlaced-gray": 1, "interlaced-rgb": 3,
             "interlaced-rgba": 4}[kind]
        px = rng.integers(0, 256, (SIZE, SIZE, c), dtype=np.uint8)
        write_interlaced(path, px if c > 1 else px[..., 0])


KINDS = ["16-bit-gray", "16-bit-bgra", "palette", "palette-alpha",
         "interlaced-gray", "interlaced-rgb", "interlaced-rgba"]


@pytest.mark.parametrize("kind", KINDS)
def test_imread_reads_each_kind_as_cv2(tmp_path, kind):
    path = str(tmp_path / f"{kind}.png")
    write_kind(path, kind, seed=len(kind))
    assert loader.unsupported_kind(path) is not None   # not the decoder's
    for flag in (image.IMREAD_UNCHANGED, image.IMREAD_GRAYSCALE):
        want = cv2.imread(path, flag)
        got = image.imread(path, flag)
        assert want is not None and got.dtype == want.dtype, (kind, flag)
        assert np.array_equal(got, want), (kind, flag)


@pytest.fixture(scope="module")
def kinds_dataset(tmp_path_factory):
    """A synthetic 4-channel dataset at SIZE whose training images are
    replaced by one file of each kind (labels kept)."""
    root = str(tmp_path_factory.mktemp("kinds"))
    jax_synthetic.generate(root, {"train": len(KINDS)}, size=SIZE, seed=6)
    img_dir = os.path.join(root, "images", "train")
    names = sorted(os.listdir(img_dir))
    for i, (name, kind) in enumerate(zip(names, KINDS)):
        path = os.path.join(img_dir, name)
        os.remove(path)
        write_kind(path, kind, seed=100 + i)
    return img_dir, names


def test_dataset_items_match_the_jax_dataset(kinds_dataset):
    img_dir, names = kinds_dataset
    ours = tds.YoloSegDataset(img_dir, imgsz=SIZE, channels=4)
    theirs = jds.YoloSegDataset(img_dir, imgsz=SIZE, channels=4)
    assert len(ours) == len(theirs) == len(KINDS)
    for i, kind in enumerate(KINDS):
        a, b = ours.load_image_raw(i), theirs.load_image_raw(i)
        assert a.dtype == b.dtype and np.array_equal(a, b), kind
        got, want = ours.item(i), theirs.item(i)
        assert set(got) == set(want), kind
        for k in want:
            assert np.array_equal(got[k], want[k]), (kind, k)


def test_decoder_still_reads_its_own_kinds(tmp_path):
    """An 8-bit non-interlaced file stays with the package's decoder; the
    same pixels interlaced go to cv2; both give the same array."""
    px = np.random.default_rng(9).integers(0, 256, (SIZE, SIZE, 3),
                                           dtype=np.uint8)
    plain, laced = str(tmp_path / "plain.png"), str(tmp_path / "laced.png")
    image.imwrite(plain, px[..., ::-1].copy())
    write_interlaced(laced, px)
    assert loader.unsupported_kind(plain) is None
    assert "interlaced" in loader.unsupported_kind(laced)
    assert np.array_equal(image.imread(plain), image.imread(laced))
    assert np.array_equal(image.imread(laced), px[..., ::-1])
