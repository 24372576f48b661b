"""A flax msgpack checkpoint decoded into a nested dict of NumPy arrays, with
NumPy and the standard library alone (a frozen copy of the decoder the
program carries, kept here so that the reference reads the file itself)."""
from __future__ import annotations

import struct
from typing import Any, Dict

import numpy as np

# flax's msgpack extension types: an ndarray, packed [shape, dtype, bytes],
# and a numpy scalar, packed the same way with shape [].
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_SIZED = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",     # bin
          0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str
          0xDC: ">H", 0xDD: ">I",                 # array
          0xDE: ">H", 0xDF: ">I",                 # map
          0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}     # ext
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, buf: bytes):
        self.buf, self.pos = memoryview(buf), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos += n
        return self.buf[self.pos - n:self.pos]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b in (0xC0, 0xC2, 0xC3):
            return {0xC0: None, 0xC2: False, 0xC3: True}[b]
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _SIZED:
            n = self.unpack(_SIZED[b])
            if b <= 0xC6:
                return bytes(self.take(n))
            if 0xD9 <= b <= 0xDB:
                return str(self.take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return [self.read() for _ in range(n)]
            if b in (0xDE, 0xDF):
                return self.map(n)
            return self.ext(n)
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = _Reader(data).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def read_checkpoint(path: str) -> Dict[str, Any]:
    """{params, batch_stats, et} of a flax msgpack checkpoint, as NumPy."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree
