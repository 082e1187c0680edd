"""A small msgpack reader and writer for Flax-serialized parameter files.

The zoo's ``params.msgpack`` files are written by
``flax.serialization.to_bytes``: msgpack maps of str -> map or array leaf,
where each array leaf is ext type 1 whose payload is itself msgpack
``(shape, dtype_name, raw C-order bytes)``. This module reads and writes
that format with the standard library and numpy alone, because the machine
that runs the port has no ``msgpack`` package. ``to_bytes`` gives the bytes
Flax gives for the same tree of numpy arrays.

Of Flax's extension types only the ndarray one is handled (scalars,
complex numbers and arrays chunked above 1 GiB do not occur in parameter
files; they raise). Arrays come back as read-only ``np.frombuffer`` views,
as Flax returns them.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["unpackb", "restore", "packb", "to_bytes"]

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def sint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big", signed=True)

    def str_(self, n: int) -> str | bytes:
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, n: int) -> Any:
        code = self.sint(1)
        payload = bytes(self.take(n))
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(payload)
        raise ValueError(f"unsupported msgpack ext type {code}")

    def obj(self) -> Any:
        t = self.uint(1)
        if t <= 0x7F:
            return t
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        if t >= 0xE0:
            return t - 0x100
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.uint(1 << (t - 0xC4))))
        if t in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self.ext(self.uint(1 << (t - 0xC7)))
        if t == 0xCA:
            return struct.unpack(">f", self.take(4))[0]
        if t == 0xCB:
            return struct.unpack(">d", self.take(8))[0]
        if 0xCC <= t <= 0xCF:  # uint 8/16/32/64
            return self.uint(1 << (t - 0xCC))
        if 0xD0 <= t <= 0xD3:  # int 8/16/32/64
            return self.sint(1 << (t - 0xD0))
        if 0xD4 <= t <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self.str_(self.uint(1 << (t - 0xD9)))
        if t in (0xDC, 0xDD):  # array 16/32
            return self.array(self.uint(2 << (t - 0xDC)))
        if t in (0xDE, 0xDF):  # map 16/32
            return self.map(self.uint(2 << (t - 0xDE)))
        raise ValueError(f"invalid msgpack type byte 0x{t:02x}")


def unpackb(data: bytes, raw: bool = False) -> Any:
    """Decode one msgpack object. ``raw`` keeps str payloads as bytes."""
    r = _Reader(data, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _ndarray_from_bytes(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(payload, raw=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 leaves are not supported by this reader")
    dtype = np.dtype(dtype_name.decode("ascii"))
    return np.frombuffer(buffer, dtype=dtype).reshape(shape, order="C")


def restore(data: bytes) -> Any:
    """Counterpart of ``flax.serialization.msgpack_restore`` for parameter
    trees (nested maps of arrays below Flax's 1 GiB chunking size)."""
    tree = unpackb(data)
    if not isinstance(tree, dict):
        raise ValueError("not a Flax parameter tree")
    return tree


def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, ...]) -> None:
    """A length header: the fix form for ``n <= fix_max``, else the first
    of ``codes`` (8/16/32-bit or 16/32-bit lengths) whose width holds n."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    widths = (1, 2, 4)[-len(codes):]
    for code, w in zip(codes, widths):
        if n < 1 << (8 * w):
            out.append(code)
            out += n.to_bytes(w, "big")
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, np.ndarray):
        payload = _ndarray_to_bytes(obj)
        n = len(payload)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + n.bit_length() - 1)  # fixext 1/2/4/8/16
        else:
            _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))  # ext 8/16/32
        out.append(_EXT_NDARRAY)
        out += payload
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 15, (0xDE, 0xDF))
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"map keys must be str, got {k!r}")
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 15, (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif isinstance(obj, bytes):
        _head(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        if obj <= 0x7F:
            out.append(obj)
        else:
            for code, w in ((0xCC, 1), (0xCD, 2), (0xCE, 4), (0xCF, 8)):
                if obj < 1 << (8 * w):
                    out.append(code)
                    out += obj.to_bytes(w, "big")
                    return
            raise ValueError(f"integer {obj} too large for msgpack")
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a "
                        "parameter file")


def packb(obj: Any) -> bytes:
    """Encode maps (str keys), arrays, str, bytes, non-negative ints and
    numpy arrays (Flax's ndarray ext type), as ``msgpack.packb`` with
    ``use_bin_type=True`` does."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"cannot serialize a {arr.dtype} array")
    return packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])


def to_bytes(tree: dict) -> bytes:
    """Counterpart of ``flax.serialization.to_bytes`` for a nested dict of
    numpy arrays below Flax's 1 GiB chunking size."""
    if not isinstance(tree, dict):
        raise TypeError("a parameter tree is a dict")
    return packb(tree)
