"""The msgpack codec of flax-msgpack checkpoints (the part of
``flax.serialization`` that the JAX package's checkpoints use), in plain
Python over numpy: no ``msgpack`` or ``flax`` package is needed.

``to_bytes(tree)`` gives the bytes that the JAX package's
``save_checkpoint`` writes for the same tree (``flax.serialization.to_bytes``
of ``jax.device_get(tree)``), and ``msgpack_restore(data)`` the tree that
``flax.serialization.msgpack_restore`` returns:

* nil, bool, int (every width, the smallest encoding as msgpack-python
  packs it), float64 (a Python float; float32 is read), str, bin, array
  and map, each in every length class, and ext;
* flax's ext codes: 1 an ndarray as ``(shape, dtype name, C-order
  bytes)``, 2 a complex as ``(real, imag)``, 3 a numpy scalar (packed as
  a 0-d ndarray);
* map keys sorted at every level, as ``jax.device_get`` leaves them;
* an array of more than ``MAX_CHUNK_SIZE`` bytes as flax's
  ``__msgpack_chunked_array__`` map of flat chunks, joined again on read.

Arrays go in and out whole (a memoryview on write, ``np.frombuffer`` on
read: read-only views of ``data``, as flax returns), never element by
element.  Tuples and lists are written as arrays and read as lists.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["MAX_CHUNK_SIZE", "packb", "unpackb", "to_bytes", "msgpack_restore"]

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


# ---------------------------------------------------------------- writing
def _int(out: list, v: int) -> None:
    # msgpack-python's choice: unsigned formats for v >= 0, signed below
    if v < -(1 << 5):
        if v < -(1 << 15):
            if v < -(1 << 31):
                if v < -(1 << 63):
                    raise OverflowError(f"int {v} below int64")
                out.append(struct.pack(">Bq", 0xD3, v))
            else:
                out.append(struct.pack(">Bi", 0xD2, v))
        elif v < -(1 << 7):
            out.append(struct.pack(">Bh", 0xD1, v))
        else:
            out.append(struct.pack(">Bb", 0xD0, v))
    elif v < (1 << 7):
        out.append(struct.pack(">b", v))  # positive or negative fixint
    elif v < (1 << 8):
        out.append(struct.pack(">BB", 0xCC, v))
    elif v < (1 << 16):
        out.append(struct.pack(">BH", 0xCD, v))
    elif v < (1 << 32):
        out.append(struct.pack(">BI", 0xCE, v))
    elif v < (1 << 64):
        out.append(struct.pack(">BQ", 0xCF, v))
    else:
        raise OverflowError(f"int {v} above uint64")


def _header(out: list, n: int, fix: int | None, fix_max: int, c8: int | None,
            c16: int, c32: int) -> None:
    """The type-and-length header of a str, bin, array or map of ``n``."""
    if fix is not None and n <= fix_max:
        out.append(struct.pack(">B", fix | n))
    elif c8 is not None and n < (1 << 8):
        out.append(struct.pack(">BB", c8, n))
    elif n < (1 << 16):
        out.append(struct.pack(">BH", c16, n))
    elif n < (1 << 32):
        out.append(struct.pack(">BI", c32, n))
    else:
        raise ValueError(f"msgpack object of {n} items or bytes is too long")


def _str(out: list, s: str) -> None:
    b = s.encode("utf-8")
    _header(out, len(b), 0xA0, 31, 0xD9, 0xDA, 0xDB)
    out.append(b)


def _bin(out: list, b) -> None:
    _header(out, len(b), None, 0, 0xC4, 0xC5, 0xC6)
    out.append(b)


def _ext(out: list, code: int, pieces: list) -> None:
    n = sum(len(p) for p in pieces)
    if n in _FIXEXT:
        out.append(struct.pack(">Bb", _FIXEXT[n], code))
    elif n < (1 << 8):
        out.append(struct.pack(">BBb", 0xC7, n, code))
    elif n < (1 << 16):
        out.append(struct.pack(">BHb", 0xC8, n, code))
    elif n < (1 << 32):
        out.append(struct.pack(">BIb", 0xC9, n, code))
    else:
        raise ValueError(f"msgpack ext of {n} bytes is too long")
    out.extend(pieces)


def _ndarray_pieces(arr: np.ndarray) -> list:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype.name, bytes))``,
    the bytes as a view of the (C-ordered) array."""
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialised")
    if not arr.flags.c_contiguous:
        arr = arr.copy(order="C")  # not ascontiguousarray: it makes a 0-d array 1-d
    pieces: list = [b"\x93"]
    _header(pieces, len(arr.shape), 0x90, 15, None, 0xDC, 0xDD)
    for d in arr.shape:
        _int(pieces, int(d))
    _str(pieces, arr.dtype.name)
    _bin(pieces, memoryview(arr.reshape(-1)).cast("B") if arr.size else b"")
    return pieces


def _pack(out: list, x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif isinstance(x, np.ndarray):
        _ext(out, EXT_NDARRAY, _ndarray_pieces(x))
    elif isinstance(x, np.generic):
        _ext(out, EXT_NPSCALAR, _ndarray_pieces(np.asarray(x)))
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(struct.pack(">Bd", 0xCB, x))
    elif type(x) is complex:
        inner: list = [b"\x92"]
        _pack(inner, x.real)
        _pack(inner, x.imag)
        _ext(out, EXT_COMPLEX, inner)
    elif isinstance(x, str):
        _str(out, x)
    elif isinstance(x, (bytes, bytearray, memoryview)):
        _bin(out, x)
    elif isinstance(x, dict):
        _header(out, len(x), 0x80, 15, None, 0xDE, 0xDF)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 15, None, 0xDC, 0xDD)
        for v in x:
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def packb(x: Any) -> bytes:
    """Plain msgpack of ``x`` with flax's ext types; maps keep their order."""
    out: list = []
    _pack(out, x)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    """flax's ``_chunk``: the flat array cut into chunks of at most
    ``MAX_CHUNK_SIZE`` bytes."""
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
            "chunks": {str(j): flat[i:i + size] for j, i in enumerate(range(0, n, size))}}


def _canonical(x: Any) -> Any:
    """Maps sorted by key at every level (``jax.tree_util``'s order) and
    arrays over ``MAX_CHUNK_SIZE`` chunked, as flax writes a tree."""
    if isinstance(x, dict):
        return {k: _canonical(x[k]) for k in sorted(x)}
    if isinstance(x, (list, tuple)):
        return [_canonical(v) for v in x]
    if isinstance(x, np.ndarray) and x.size * x.dtype.itemsize > MAX_CHUNK_SIZE:
        return _chunk(x)
    return x


def to_bytes(tree: Any) -> bytes:
    """The bytes of a flax-msgpack file for ``tree`` (a nested dict with
    numpy or Python leaves)."""
    return packb(_canonical(tree))


# ---------------------------------------------------------------- reading
class _Reader:
    __slots__ = ("data", "pos")

    def __init__(self, data):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> int:
        start = self.pos
        self.pos += n
        if self.pos > len(self.data):
            raise ValueError("msgpack data ends early")
        return start

    def unpack(self, fmt: str, n: int):
        return struct.unpack_from(fmt, self.data, self.take(n))[0]

    def raw(self, n: int):
        start = self.take(n)
        return self.data[start:start + n]

    def obj(self) -> Any:
        b = self.unpack(">B", 1)
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b in _SCALARS:
            fmt, n = _SCALARS[b]
            return self.unpack(fmt, n)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.raw(self.length(b - 0xC4)))
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.length(b - 0xD9))
        if b in (0xDC, 0xDD):
            return self.array(self.length(b - 0xDC + 1))
        if b in (0xDE, 0xDF):
            return self.map(self.length(b - 0xDE + 1))
        if 0xD4 <= b <= 0xD8:
            return self.ext(1 << (b - 0xD4))
        if b in (0xC7, 0xC8, 0xC9):
            return self.ext(self.length(b - 0xC7))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {self.pos - 1}")

    def length(self, cls: int) -> int:
        """The length field of class 0 (8 bits), 1 (16) or 2 (32)."""
        return self.unpack((">B", ">H", ">I")[cls], 1 << cls)

    def string(self, n: int) -> str:
        return bytes(self.raw(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b", 1)
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = self.ndarray(end)
            return arr[()] if code == EXT_NPSCALAR else arr
        if code != EXT_COMPLEX:
            raise ValueError(f"msgpack ext type {code} is none of flax's")
        re_, im = self.obj()
        if self.pos != end:
            raise ValueError("msgpack complex ext length disagrees with its content")
        return complex(re_, im)

    def ndarray(self, end: int) -> np.ndarray:
        """flax's ``_ndarray_from_bytes`` on the ext's data: a view of it."""
        if self.unpack(">B", 1) != 0x93:
            raise ValueError("msgpack ndarray ext is not a 3-array")
        shape = tuple(self.obj())
        name = self.obj()
        name = name.decode() if isinstance(name, bytes) else name
        b = self.unpack(">B", 1)
        if b not in (0xC4, 0xC5, 0xC6):
            raise ValueError("msgpack ndarray ext holds no bin")
        n = self.length(b - 0xC4)
        start = self.take(n)
        if self.pos != end:
            raise ValueError("msgpack ndarray ext length disagrees with its content")
        dtype = np.dtype(name)
        return np.frombuffer(self.data, dtype, n // dtype.itemsize, start).reshape(shape)


_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}


def unpackb(data) -> Any:
    """The object of plain msgpack ``data`` (with flax's ext types)."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(data):
        raise ValueError(f"msgpack: {len(data) - r.pos} bytes after the object")
    return out


def _unchunk(x: Any) -> Any:
    if isinstance(x, dict):
        if _CHUNKED in x:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def msgpack_restore(data) -> Any:
    """The tree of a flax-msgpack file's bytes, chunked arrays joined."""
    return _unchunk(unpackb(data))
