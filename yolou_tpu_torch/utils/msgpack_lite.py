"""A small msgpack codec for flax's checkpoint encoding, numpy and torch only.

The JAX package writes `.ckpt` files with `flax.serialization.
msgpack_serialize`: a msgpack map tree whose array leaves are msgpack ext
type 1 holding the packed tuple (shape, dtype name, C-order bytes), and whose
numpy scalars are ext type 3 with the same payload. This module encodes and
decodes that format byte for byte as msgpack-python does under flax's
settings (`use_bin_type=True`, `strict_types=True`, shortest encodings),
without `msgpack`, `flax` or JAX, none of which the GPU machine has.

Encoded: None, bool, int (int64 / uint64 range), float (as float64), str,
bytes, dict with str keys (in sorted order, as flax writes them), list,
numpy arrays and scalars, and torch tensors (as arrays). `bfloat16` has no numpy dtype here: it is written from, and
read back as, a torch.bfloat16 tensor through its uint16 bits. Anything else
raises by name: tuples (flax's packer refuses them too), complex numbers,
object and structured dtypes, other ext types, and flax's chunked form of
arrays over 2**30 bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_KEY = "__msgpack_chunked_array__"


# ------------------------------------------------------------------ packing

def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} is out of range")
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                out += bytes([code]) + struct.pack(fmt, v)
                return
        raise OverflowError(f"msgpack: int {v} is out of range")


def _pack_len(n: int, fix: Tuple[int, int], codes, out: bytearray) -> None:
    """A length header: the fix form (base, limit) where it fits, else the
    first of `codes` ((code, struct format, limit), ...) that does."""
    base, limit = fix
    if n < limit:
        out.append(base | n)
        return
    for code, fmt, top in codes:
        if n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARR = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _pack_str(s: str, out: bytearray) -> None:
    b = s.encode("utf-8")
    _pack_len(len(b), (0xA0, 32), _STR, out)
    out += b


def _pack_bin(b: bytes, out: bytearray) -> None:
    _pack_len(len(b), (0, 0), _BIN, out)
    out += b


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    if len(data) in _FIXEXT:
        out.append(_FIXEXT[len(data)])
    else:
        _pack_len(len(data), (0, 0), _EXT, out)
    out.append(code)
    out += data


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    """flax `_ndarray_to_bytes`: packb((shape, dtype name, bytes))."""
    out = bytearray([0x93])
    _pack_len(len(shape), (0x90, 16), _ARR, out)
    for d in shape:
        _pack_int(int(d), out)
    _pack_str(dtype_name, out)
    _pack_bin(data, out)
    return bytes(out)


def _numpy_payload(a: np.ndarray) -> bytes:
    if a.dtype.hasobject or a.dtype.isalignedstruct or a.dtype.names:
        raise TypeError(f"msgpack: dtype {a.dtype} is not supported")
    if a.dtype.kind == "c":
        raise TypeError("msgpack: complex arrays are not supported")
    return _array_payload(a.shape, a.dtype.name, a.tobytes("C"))


def _tensor_payload(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return _array_payload(tuple(t.shape), "bfloat16",
                              t.view(torch.int16).numpy().tobytes("C"))
    return _numpy_payload(t.numpy())


def _pack(x: Any, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, np.ndarray):
        _pack_ext(EXT_NDARRAY, _numpy_payload(x), out)
    elif isinstance(x, np.generic):
        _pack_ext(EXT_NPSCALAR, _numpy_payload(np.asarray(x)), out)
    elif isinstance(x, torch.Tensor):
        _pack_ext(EXT_NDARRAY, _tensor_payload(x), out)
    elif type(x) is int:
        _pack_int(x, out)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        _pack_str(x, out)
    elif type(x) is bytes:
        _pack_bin(x, out)
    elif isinstance(x, dict):
        if any(type(k) is not str for k in x):
            raise TypeError(f"msgpack: a map key of {sorted(map(repr, x))} "
                            f"is not a str")
        _pack_len(len(x), (0x80, 16), _MAP, out)
        for k in sorted(x):     # flax's tree copy sorts the keys
            _pack_str(k, out)
            _pack(x[k], out)
    elif type(x) is list:
        _pack_len(len(x), (0x90, 16), _ARR, out)
        for v in x:
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: can not serialize {type(x).__name__!r} "
                        f"object")


def packb(tree: Any) -> bytes:
    """Encode `tree` as `flax.serialization.msgpack_serialize` encodes the
    same tree of numpy leaves (torch tensors are encoded as their arrays)."""
    out = bytearray()
    _pack(tree, out)
    return bytes(out)


# ---------------------------------------------------------------- unpacking

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
          0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
        0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
        0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}


def _unpack(r: _Reader, raw: bool) -> Any:
    b = r.num(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F, raw)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r, raw) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return _str(r.take(b & 0x1F), raw)
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _FIXED:
        return r.num(_FIXED[b])
    if b in (0xC4, 0xC5, 0xC6):
        return bytes(r.take(r.num(_LEN[b])))
    if b in (0xD9, 0xDA, 0xDB):
        return _str(r.take(r.num(_LEN[b])), raw)
    if b in (0xDC, 0xDD):
        return [_unpack(r, raw) for _ in range(r.num(_LEN[b]))]
    if b in (0xDE, 0xDF):
        return _map(r, r.num(_LEN[b]), raw)
    if 0xD4 <= b <= 0xD8:
        n = 1 << (b - 0xD4)
    elif b in (0xC7, 0xC8, 0xC9):
        n = r.num(_LEN[b])
    else:
        raise ValueError(f"msgpack: reserved byte 0x{b:02x}")
    code = r.num(">b")
    return _ext(code, bytes(r.take(n)))


def _str(b: memoryview, raw: bool):
    return bytes(b) if raw else str(b, "utf-8")


def _map(r: _Reader, n: int, raw: bool) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"msgpack: map key {k!r} is not a str")
        out[k] = _unpack(r, raw)
    return out


def _array_from_payload(data: bytes):
    r = _Reader(data)
    tpl = _unpack(r, raw=True)
    if r.pos != len(data) or not (isinstance(tpl, list) and len(tpl) == 3):
        raise ValueError("msgpack: malformed array payload")
    shape, name, buf = tpl
    name = name.decode("ascii")
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from_payload(data)
    if code == EXT_NPSCALAR:
        a = _array_from_payload(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack: ext type {code} is not supported")


def _no_chunks(tree: Any) -> None:
    if isinstance(tree, dict):
        if CHUNKED_KEY in tree:
            raise ValueError("msgpack: chunked arrays (flax's form for arrays "
                             "over 2**30 bytes) are not supported")
        for v in tree.values():
            _no_chunks(v)


def unpackb(data: bytes) -> Any:
    """Decode what `packb` (or `flax.serialization.msgpack_serialize`)
    wrote, as `flax.serialization.msgpack_restore` does: numpy arrays (read
    only, over the data), numpy scalars, and torch.bfloat16 tensors where
    the dtype is bfloat16."""
    r = _Reader(data)
    tree = _unpack(r, raw=False)
    if r.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the object")
    _no_chunks(tree)
    return tree
