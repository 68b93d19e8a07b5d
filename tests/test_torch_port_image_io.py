"""PyTorch port: the host image I/O (`native/`) against cv2, bit for bit.

The PNG decoder is built with g++ here as on the card's machine. `imread`
must give what `cv2.imread` gives (the channel order, gray+alpha as four
channels, libpng's fixed-point luma for the grayscale flag) on PNGs that
cv2 writes and on PNGs this file assembles with each scanline filter;
`imwrite`'s files must read back through cv2 unchanged. `resize_linear`
must equal `cv2.resize(..., INTER_LINEAR)` exactly for uint8 (cv2's
fixed-point form) and within 1e-6 for float32, `resize_nearest` exactly,
and `fill_poly` must equal `cv2.fillPoly` (lineType 8, shift 0) exactly on
seeded random polygons and on every label of a synthetic dataset. Files the
decoder does not read (16-bit, palette, interlaced) must raise naming the
file and its kind, from the decoder and from `imread` where cv2 is absent
(`test_torch_port_image_kinds.py` reads them through cv2).
"""

import os
import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from yolou_tpu.data import synthetic as jax_synthetic
from yolou_tpu_torch.data.yolo_dataset import img2label_path, parse_label_file
from yolou_tpu_torch.native import image, loader

from .torch_threads import one_torch_thread  # noqa: F401

KINDS = {"gray": 1, "bgr": 3, "bgra": 4}


def _img(rng, h, w, c):
    a = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    return a[..., 0] if c == 1 else a


def _read_both(path):
    for flag in (cv2.IMREAD_UNCHANGED, cv2.IMREAD_GRAYSCALE):
        want = cv2.imread(path, flag)
        got = image.imread(path, flag)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape, (flag, got.shape, want.shape)
        assert np.array_equal(got, want), flag


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("kind", list(KINDS))
def test_imread_matches_cv2_on_files_cv2_writes(tmp_path, kind, level):
    """Unchanged and grayscale, at three compression levels."""
    rng = np.random.default_rng(level * 7 + KINDS[kind])
    path = str(tmp_path / f"{kind}.png")
    assert cv2.imwrite(path, _img(rng, 37, 53, KINDS[kind]),
                       [cv2.IMWRITE_PNG_COMPRESSION, level])
    _read_both(path)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _assemble(rows, ctype, filters, depth=8, interlace=0):
    """A PNG from raw scanlines (H, stride) in file order, each row filtered
    with its entry of `filters`, by a per-byte loop (independent of the
    port's vectorised encoder)."""
    h, stride = rows.shape
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    out = bytearray()
    for y in range(h):
        f = filters[y % len(filters)]
        out.append(f)
        for x in range(stride):
            a = int(rows[y, x - bpp]) if x >= bpp else 0
            b = int(rows[y - 1, x]) if y else 0
            c = int(rows[y - 1, x - bpp]) if (y and x >= bpp) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[f]
            out.append((int(rows[y, x]) - pred) & 0xFF)
    width = stride // bpp
    ihdr = struct.pack(">IIBBBBB", width, h, depth, ctype, 0, 0, interlace)
    return (image.PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(bytes(out)))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
@pytest.mark.parametrize("filt", range(5))
def test_imread_matches_cv2_on_each_filter(tmp_path, filt, ctype):
    """Every scanline filter (0 none, 1 sub, 2 up, 3 average, 4 Paeth) in
    gray, RGB, gray+alpha and RGBA; the last case mixes all five."""
    bpp = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.default_rng(filt * 10 + ctype)
    rows = rng.integers(0, 256, (9, 11 * bpp), dtype=np.uint8)
    rows[3:5] = rows[2]                       # runs that favour "up"
    filters = [filt] if not (filt == 4 and ctype == 6) else list(range(5))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_assemble(rows, ctype, filters))
    _read_both(path)


@pytest.mark.parametrize("filt", range(5))
@pytest.mark.parametrize("kind", list(KINDS))
def test_imwrite_reads_back_through_cv2(tmp_path, kind, filt):
    rng = np.random.default_rng(filt + 20 * KINDS[kind])
    img = _img(rng, 31, 45, KINDS[kind])
    path = str(tmp_path / "w.png")
    image.imwrite(path, img, filter_type=filt)
    assert np.array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    assert np.array_equal(image.imread(path), img)


RESIZES = [((160, 160), (640, 640)), ((155, 201), (160, 160)),
           ((40, 40), (640, 640)), ((480, 640), (160, 160)),
           ((7, 13), (160, 160)), ((160, 160), (80, 80)),
           ((640, 640), (160, 160)), ((160, 160), (155, 157)),
           ((64, 64), (33, 97)), ((5, 3), (7, 11)), ((100, 100), (99, 101)),
           ((17, 250), (3, 1000))]


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_matches_cv2(src, dst, c):
    """uint8 INTER_LINEAR and INTER_NEAREST exactly, float32 INTER_LINEAR
    within 1e-6: up, down, odd sizes, 1/3/4 channels, 640^2 <-> 160^2."""
    rng = np.random.default_rng(src[0] * 1000 + dst[1] + c)
    a = _img(rng, *src, c)
    (oh, ow) = dst
    want = cv2.resize(a, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = image.resize_linear(a, (ow, oh))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert np.array_equal(got, want)
    af = a.astype(np.float32) / 255
    want = cv2.resize(af, (ow, oh), interpolation=cv2.INTER_LINEAR)
    got = image.resize_linear(af, (ow, oh))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want = cv2.resize(a, (ow, oh), interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(image.resize_nearest(a, dst), want)


def _polygons(kind, rng, count=50):
    for _ in range(count):
        s = int(rng.integers(8, 90))
        n = int(rng.integers(3, 14))
        if kind in ("convex", "concave"):
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            lo = 0.45 if kind == "convex" else 0.1
            r = rng.uniform(lo, 0.5, n) * s
            pts = np.stack([s / 2 + r * np.cos(ang), s / 2 + r * np.sin(ang)],
                           1)
        elif kind == "self-touching":
            pts = rng.uniform(0, s, (n, 2))
            pts[int(rng.integers(2, n))] = pts[0]     # a vertex revisited
            pts = np.concatenate([pts, pts[:2][::-1]])  # an edge retraced
        else:                                         # off the image
            pts = rng.uniform(-1.5 * s, 2.5 * s, (n, 2))
        yield s, np.round(pts).astype(np.int32)


@pytest.mark.parametrize("kind", ["convex", "concave", "self-touching",
                                  "off-image"])
def test_fill_poly_matches_cv2(kind):
    """50 seeded polygons of each kind (200 in all), on canvases of
    varying aspect."""
    rng = np.random.default_rng(["convex", "concave", "self-touching",
                                 "off-image"].index(kind))
    filled = 0
    for s, pts in _polygons(kind, rng):
        w = int(s * rng.uniform(0.5, 2.0)) + 1
        want = np.zeros((s, w), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = image.fill_poly(np.zeros((s, w), np.uint8), [pts], 1)
        assert np.array_equal(got, want), pts.tolist()
        filled += int(want.sum() > 0)
    assert filled >= 25


def test_fill_poly_matches_cv2_on_synthetic_labels(tmp_path):
    """Every label of a synthetic dataset at the sizes the datasets use it:
    imgsz 160 and 64, and a non-square letterbox frame."""
    jax_synthetic.generate(str(tmp_path), {"train": 24}, size=160, seed=4)
    img_dir = tmp_path / "images" / "train"
    n = 0
    for name in sorted(os.listdir(img_dir)):
        for _, poly in parse_label_file(img2label_path(str(img_dir / name))):
            for (h, w) in ((160, 160), (64, 64), (96, 128)):
                pts = np.round(poly * np.array([w, h], np.float32)
                               ).astype(np.int32)
                want = np.zeros((h, w), np.uint8)
                cv2.fillPoly(want, [pts], 1)
                got = image.fill_poly(np.zeros((h, w), np.uint8), [pts], 1)
                assert np.array_equal(got, want)
            n += 1
    assert n >= 12


@pytest.mark.parametrize("what", ["16-bit", "palette", "interlaced"])
def test_unsupported_pngs_raise_by_name(tmp_path, what, monkeypatch):
    path = str(tmp_path / f"{what}.png")
    if what == "16-bit":
        assert cv2.imwrite(path, np.full((4, 5), 1000, np.uint16))
        want = "colour type 0 = gray, bit depth 16"
    else:
        rows = np.zeros((4, 5), np.uint8)
        ctype = 3 if what == "palette" else 0
        with open(path, "wb") as f:
            f.write(_assemble(rows, 0, [0])[:8] + _chunk(
                b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, ctype, 0, 0,
                                     int(what == "interlaced")))
                    + _chunk(b"IDAT", zlib.compress(bytes(24)))
                    + _chunk(b"IEND", b""))
        want = ("colour type 3 = palette, bit depth 8" if what == "palette"
                else "interlaced")
    with pytest.raises(IOError) as e:
        loader.decode_png(path)
    assert path in str(e.value) and want in str(e.value), str(e.value)
    # imread hands such a file to cv2, and names it where cv2 is absent
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(IOError) as e:
        image.imread(path)
    assert path in str(e.value) and want in str(e.value), str(e.value)
    assert "cv2 is not installed" in str(e.value)


def test_missing_and_foreign_files_raise(tmp_path):
    with pytest.raises(IOError, match="no such file"):
        image.imread(str(tmp_path / "absent.png"))
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    assert image.imread(path).shape == (8, 8, 3)       # through cv2
    with open(path, "rb") as f, open(tmp_path / "y.png", "wb") as g:
        g.write(f.read())                              # JPEG bytes, .png name
    assert image.imread(str(tmp_path / "y.png")).shape == (8, 8, 3)
    assert loader.library_path().exists()
