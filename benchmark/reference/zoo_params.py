"""The zoo's parameter files, read with the standard library and numpy.

A frozen copy of the reader half of ``music_synthesis_tpu_torch/_msgpack.py``
and of ``convert.flatten_params`` / ``to_state_dict`` at commit 29bca4e, so
that the reference reads ``zoo/<entry>/params.msgpack`` (the raw file both
sides load) without importing the program. ``state_dict`` flattens the Flax
tree into the parameter names of ``reference.model``'s modules.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

__all__ = ["unpackb", "restore", "state_dict"]

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


def state_dict(path) -> dict:
    """``zoo/<entry>/params.msgpack`` -> ``{name: float32 torch tensor}``:
    the tree flattened with ``.``, Flax's Dense ``kernel [in, out]`` turned
    into ``nn.Linear``'s ``weight [out, in]``."""
    import torch

    out = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            key = f"{prefix}{k}"
            if isinstance(v, dict):
                walk(v, key + ".")
                continue
            t = torch.tensor(np.array(v, dtype=np.float32))
            head, _, leaf = key.rpartition(".")
            if leaf == "kernel":
                out[f"{head}.weight"] = t.T.contiguous()
            elif leaf in ("bias", "v", "g", "b"):
                out[key] = t
            else:
                raise ValueError(f"unexpected parameter {key!r}")

    with open(path, "rb") as fh:
        walk(restore(fh.read()), "")
    return out
