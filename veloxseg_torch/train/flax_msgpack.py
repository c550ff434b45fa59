"""Reader of flax msgpack checkpoints, without flax or msgpack.

The JAX trainer writes ``.ckpt`` files with
``flax.serialization.msgpack_serialize`` (``veloxseg_tpu/train/
checkpoint.py:47-63``): a msgpack tree of maps, arrays, strings and
numbers whose array leaves are msgpack ext objects. Ext code 1 is an
ndarray and code 3 a numpy scalar; the payload of both is itself msgpack,
``(shape, dtype name, C-order bytes)``. :func:`msgpack_restore` decodes
such a file as ``flax.serialization.msgpack_restore`` does (arrays come
back as lists, ndarrays as numpy arrays). It raises on what the JAX
trainer's checkpoints never hold: other ext codes (complex scalars),
bfloat16 arrays, and flax's chunked form of arrays over 2³⁰ bytes.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-width big-endian formats: integers, floats
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# length prefixes: bin, str, array and map; ext with its size
_LEN = {0xc4: ">B", 0xc5: ">H", 0xc6: ">I", 0xd9: ">B", 0xda: ">H",
        0xdb: ">I", 0xdc: ">H", 0xdd: ">I", 0xde: ">H", 0xdf: ">I",
        0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return [self.value() for _ in range(b & 0x0f)]
        if 0xa0 <= b <= 0xbf:
            return str(self._take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in _SCALARS:
            return self._unpack(_SCALARS[b])
        if b in _FIXEXT:
            return self._ext(_FIXEXT[b])
        if b not in _LEN:
            raise ValueError(f"unknown msgpack type byte 0x{b:02x}")
        n = self._unpack(_LEN[b])
        if b <= 0xc6:
            return bytes(self._take(n))
        if b <= 0xc9:
            return self._ext(n)
        if b <= 0xdb:
            return str(self._take(n), "utf-8")
        if b <= 0xdd:
            return [self.value() for _ in range(n)]
        return self._map(n)

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if _CHUNKED in out:
            raise ValueError("flax's chunked array form (arrays over 2**30 "
                             "bytes) is not supported")
        return out

    def _ext(self, n: int) -> Any:
        code = struct.unpack(">b", self._take(1))[0]
        payload = self._take(n)
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext code {code}")
        arr = _ndarray(payload)
        return arr[()] if code == _EXT_NPSCALAR else arr


def _ndarray(payload: memoryview) -> np.ndarray:
    shape, name, data = _Reader(payload).value()
    if name == "bfloat16":
        raise ValueError("bfloat16 arrays are not supported")
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()


def msgpack_restore(data: bytes) -> Any:
    """Decode one flax msgpack tree (``flax.serialization.msgpack_restore``
    without flax)."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes "
                         "after the msgpack tree")
    return out
