"""The cv2 calls of the package's disk paths, with cv2's exact results.

`imread` and `imwrite` read and write PNG through this package's own
decoder (`loader.py`) and stdlib `zlib`; `resize_linear`, `resize_nearest`
and `fill_poly` compute in numpy what `cv2.resize` (INTER_LINEAR,
INTER_NEAREST) and `cv2.fillPoly` (lineType 8, shift 0) compute, bit for
bit, so that the network sees the bytes the JAX package sees through cv2.
JPEG, BMP, TIFF and WEBP files, and the PNGs the decoder does not read
(16-bit, palette, interlaced), go to cv2, imported inside the call, as the
JAX package reads every image; where cv2 is absent such a file raises an
error that names it and its kind.
"""

from __future__ import annotations

import os
import zlib
from typing import Sequence, Tuple, Union

import numpy as np

from . import loader

IMREAD_UNCHANGED = -1
IMREAD_GRAYSCALE = 0
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# libpng's rgb_to_gray weights for cv2's (0.299, 0.587): x 32768 / 100000
_LUMA = (9797, 19234, 3737)
# cv2.resize's fixed-point INTER_LINEAR: 11-bit coefficients
_COEF_SCALE = 2048
_XY_SHIFT = 16


# ------------------------------------------------------------------ PNG I/O

def _is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def imread(path: str, flag: int = IMREAD_UNCHANGED) -> np.ndarray:
    """`cv2.imread(path, flag)` for flag IMREAD_UNCHANGED or
    IMREAD_GRAYSCALE: (H, W) for one channel, else (H, W, C) in cv2's order
    (B, G, R(, A)); gray+alpha comes back as B = G = R = gray plus alpha,
    as cv2 gives it. The grayscale of a colour PNG is libpng's fixed-point
    luma, which cv2 uses. A PNG the package's decoder does not read
    (16-bit, palette, interlaced) is cv2's, as is any other format. Raises
    where the file cannot be read."""
    if flag not in (IMREAD_UNCHANGED, IMREAD_GRAYSCALE):
        raise ValueError(f"imread: flag {flag} (only IMREAD_UNCHANGED and "
                         f"IMREAD_GRAYSCALE)")
    if not os.path.isfile(path):
        raise IOError(f"cannot read {path}: no such file")
    if not _is_png(path):
        return _imread_cv2(path, flag, "not a PNG")
    kind = loader.unsupported_kind(path)
    if kind is not None:            # 16-bit, palette, interlaced: cv2's
        return _imread_cv2(path, flag, f"a PNG of {kind}")
    img = loader.decode_png(path)
    c = img.shape[2]
    if flag == IMREAD_GRAYSCALE:
        if c <= 2:
            return img[..., 0].copy()
        b, g, r = (img[..., i].astype(np.uint32) for i in range(3))
        wr, wg, wb = _LUMA
        return ((wr * r + wg * g + wb * b) >> 15).astype(np.uint8)
    if c == 1:
        return img[..., 0]
    if c == 2:
        return img[..., [0, 0, 0, 1]]
    return img


def _imread_cv2(path: str, flag: int, what: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise IOError(f"cannot read {path}: {what}, which only cv2 reads, "
                      f"and cv2 is not installed (without it: 8-bit gray, "
                      f"gray+alpha, RGB and RGBA PNG, not interlaced)") from e
    img = cv2.imread(path, flag)
    if img is None:
        raise IOError(f"cannot read {path}")
    return img


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows: np.ndarray, bpp: int, ftype: int) -> np.ndarray:
    """PNG filter `ftype` (0 none, 1 sub, 2 up, 3 average, 4 Paeth) of every
    scanline of `rows` (H, stride) uint8, as uint8."""
    x = rows.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2,
            4: _paeth(left, up, upleft)}[ftype]
    return ((x - pred) & 0xFF).astype(np.uint8)


def imwrite(path: str, img: np.ndarray, filter_type: int = 1) -> None:
    """Write `img` (H, W) or (H, W, C) uint8, colour in cv2's order, as an
    8-bit PNG: gray (C = 1), gray+alpha (2), RGB (3) or RGBA (4). Every
    scanline takes the filter `filter_type` (0-4); zlib's default level."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"imwrite {path}: uint8 only, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}.get(c)
    if ctype is None:
        raise ValueError(f"imwrite {path}: {c} channels")
    if c >= 3:                                  # B, G, R(, A) -> R, G, B(, A)
        img = img[..., [2, 1, 0, *range(3, c)]]
    if filter_type not in range(5):
        raise ValueError(f"imwrite {path}: filter type {filter_type}")
    rows = _filter_rows(np.ascontiguousarray(img).reshape(h, w * c), c,
                        filter_type)
    raw = np.concatenate([np.full((h, 1), filter_type, np.uint8), rows], 1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (len(data).to_bytes(4, "big") + kind + data
                + zlib.crc32(kind + data).to_bytes(4, "big"))

    ihdr = (w.to_bytes(4, "big") + h.to_bytes(4, "big")
            + bytes([8, ctype, 0, 0, 0]))
    data = (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + chunk(b"IEND", b""))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


# ------------------------------------------------------------------ resize

def _linear_taps(n_in: int, n_out: int, clamp: bool, f32: bool):
    """cv2.resize's INTER_LINEAR source indices and weights along one axis:
    f = (d + 0.5) / (n_out / n_in) - 0.5 (rounded to float32 for the
    fixed-point uint8 form with `f32`, in double for float images),
    i = floor(f), the fraction f - i; with `clamp` (the x axis) the fraction
    is 0 where i < 0 or i >= n_in - 1. Returns i0, i1 (clamped to the
    image) and the float32 weights (1 - frac, frac)."""
    f = (np.arange(n_out) + 0.5) * (1.0 / (n_out / n_in)) - 0.5
    if f32:
        f = f.astype(np.float32)
    i = np.floor(f).astype(np.int64)
    frac = f - i
    if clamp:
        lo, hi = i < 0, i >= n_in - 1
        frac[lo | hi] = 0
        i = np.where(lo, 0, np.where(hi, n_in - 1, i))
    i0 = np.clip(i, 0, n_in - 1)
    i1 = np.clip(i + 1, 0, n_in - 1)
    return i0, i1, (1 - frac).astype(np.float32), frac.astype(np.float32)


def resize_linear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)`, `size` =
    (width, height): uint8 bit for bit (cv2's fixed-point form: 11-bit
    coefficients, an integer horizontal pass, the vertical pass
    ((b0 (r0 >> 4)) >> 16) + ((b1 (r1 >> 4)) >> 16) + 2) >> 2), float32
    within a float32 rounding (fractions in double, as cv2 takes them). (H, W) or (H, W, C); a single channel comes back 2-D, as from
    cv2."""
    img = np.asarray(img)
    ow, oh = size
    squeeze = img.ndim == 2 or img.shape[2] == 1
    x = img.reshape(img.shape[0], img.shape[1], -1)
    h, w = x.shape[:2]
    if x.dtype not in (np.uint8, np.float32):
        raise TypeError(f"resize_linear: uint8 or float32, not {x.dtype}")
    u8 = x.dtype == np.uint8
    x0, x1, ax0, ax1 = _linear_taps(w, ow, clamp=True, f32=u8)
    y0, y1, by0, by1 = _linear_taps(h, oh, clamp=False, f32=u8)
    if u8:
        ax0, ax1, by0, by1 = (np.rint(a * _COEF_SCALE).astype(np.int64)
                              for a in (ax0, ax1, by0, by1))
        xi = x.astype(np.int64)
        rows = xi[:, x0] * ax0[None, :, None] + xi[:, x1] * ax1[None, :, None]
        r0, r1 = rows[y0] >> 4, rows[y1] >> 4
        out = (((by0[:, None, None] * r0) >> 16)
               + ((by1[:, None, None] * r1) >> 16) + 2) >> 2
        out = np.clip(out, 0, 255).astype(np.uint8)
    else:
        rows = x[:, x0] * ax0[None, :, None] + x[:, x1] * ax1[None, :, None]
        out = by0[:, None, None] * rows[y0] + by1[:, None, None] * rows[y1]
    return out[..., 0] if squeeze else out


def resize_nearest(m: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """`cv2.resize(m, (w, h), interpolation=cv2.INTER_NEAREST)` (`out_hw` =
    (h, w)) for (H, W) or (H, W, C): source index floor(dst * (1 /
    (dst_size / src_size))), clamped."""
    (h, w), (oh, ow) = m.shape[:2], out_hw
    ys = np.minimum(np.floor(np.arange(oh) * (1.0 / (oh / h))).astype(int),
                    h - 1)
    xs = np.minimum(np.floor(np.arange(ow) * (1.0 / (ow / w))).astype(int),
                    w - 1)
    return m[ys[:, None], xs[None, :]]


# ------------------------------------------------------------------ polygons

def _clip_line(w: int, h: int, p1, p2):
    """cv2.clipLine over an image of w x h, with cv2's integer arithmetic:
    (inside, p1, p2), the segment's part inside the image where `inside`;
    otherwise the points as cv2 leaves them (moved part of the way)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(mask: np.ndarray, p1, p2, value) -> None:
    """cv2's 8-connected line (LineIterator, left to right, clipped to the
    image) from p1 to p2, drawn with `value`."""
    h, w = mask.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip_line(w, h, p1, p2)
    if not inside:
        return
    if x2 < x1:
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, abs(y2 - y1)
    sy = 1 if y2 >= y1 else -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    err, n = dx - 2 * dy, dx + 1
    xs, ys = np.empty(n, np.int64), np.empty(n, np.int64)
    x, y = x1, y1
    for k in range(n):
        xs[k], ys[k] = x, y
        step = err < 0
        err += -2 * dy + (2 * dx if step else 0)
        if vert:
            y += sy
            x += 1 if step else 0
        else:
            x += 1
            y += sy if step else 0
    mask[ys, xs] = value


def _edge(w: int, h: int, p0, p1):
    """cv2's PolyEdge of the polygon side p0 -> p1 (None when horizontal):
    (y0, y1, x at row y0, dx per row), x in 16-bit fixed point. A side
    with an end outside the image takes its slope from its clipped part
    (cv2 replaces the x of both ends by the clipped ones, and the y only
    where the clipped ends differ in y), extrapolated to its own y0."""
    (ax, ay), (bx, by) = p0, p1
    if ay == by:
        return None
    cx0, cy0, cx1, cy1 = ax << _XY_SHIFT, ay, bx << _XY_SHIFT, by
    if not (0 <= ax < w and 0 <= bx < w and 0 <= ay < h and 0 <= by < h):
        _, (tx0, ty0), (tx1, ty1) = _clip_line(w, h, p0, p1)
        cx0, cx1 = tx0 << _XY_SHIFT, tx1 << _XY_SHIFT
        if ty0 != ty1:
            cy0, cy1 = ty0, ty1
    num, den = cx1 - cx0, cy1 - cy0
    dx = abs(num) // abs(den) * (-1 if (num < 0) != (den < 0) else 1)
    if ay < by:
        return ay, by, cx0 + (ay - cy0) * dx, dx
    return by, ay, cx1 + (by - cy1) * dx, dx


def fill_poly(mask: np.ndarray,
              pts: Union[np.ndarray, Sequence[np.ndarray]],
              value) -> np.ndarray:
    """`cv2.fillPoly(mask, pts, value)` with lineType 8 and shift 0, in
    place on the 2-D `mask` (returned): every edge of every polygon drawn
    as cv2's 8-connected line, then each scanline filled between
    consecutive edge crossings (edges in 16-bit fixed point, each half-open
    in y, the crossings of a row sorted and paired, the left end of a span
    rounded up and the right end down), clipped to the image. `pts` is one (n, 2) integer (x, y) array or a list of them."""
    if isinstance(pts, np.ndarray) and pts.ndim == 2:
        pts = [pts]
    h, w = mask.shape[:2]
    edges = []
    for poly in pts:
        v = np.asarray(poly, np.int64).reshape(-1, 2).tolist()
        for p0, p1 in zip(v[-1:] + v[:-1], v):
            _line8(mask, p0, p1, value)
            e = _edge(w, h, p0, p1)
            if e is not None:
                edges.append(e)
    if len(edges) < 2:
        return mask
    ey0, ey1, ex, edx = (np.asarray(c, np.int64) for c in zip(*edges))
    ex_end = ex + (ey1 - ey0) * edx
    y_min, y_max = int(ey0.min()), int(ey1.max())
    x_min = min(int(ex.min()), int(ex_end.min()))
    x_max = max(int(ex.max()), int(ex_end.max()))
    if (y_max < 0 or y_min >= h or x_max < 0
            or x_min >= (w << _XY_SHIFT)):
        return mask
    ys = np.arange(max(y_min, 0), min(y_max, h))
    if not len(ys):
        return mask
    active = (ey0[None] <= ys[:, None]) & (ys[:, None] < ey1[None])
    xs = ex[None] + (ys[:, None] - ey0[None]) * edx[None]
    xs = np.sort(np.where(active, xs, np.iinfo(np.int64).max), axis=1)
    count = active.sum(1)
    left, right = xs[:, 0::2], xs[:, 1::2]
    npair = right.shape[1]
    pair_ok = (2 * np.arange(npair)[None] + 1) < count[:, None]
    # the left end rounds up, the right end down
    left = (left[:, :npair] + (1 << _XY_SHIFT) - 1) >> _XY_SHIFT
    right = right >> _XY_SHIFT
    ok = pair_ok & (left < w) & (right >= 0)
    r, p = np.nonzero(ok)
    a = np.maximum(left[r, p], 0)
    b = np.minimum(right[r, p], w - 1)
    span = np.zeros((len(ys), w + 1), np.int32)
    np.add.at(span, (r, a), 1)
    np.add.at(span, (r, b + 1), -1)
    filled = np.cumsum(span[:, :w], axis=1) > 0
    rows = mask[ys]
    rows[filled] = value
    mask[ys] = rows
    return mask
