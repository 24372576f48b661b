"""Checkpoints of the JAX package, read into PyTorch.

`read_flax_msgpack` decodes a flax `serialization.to_bytes` file with no
dependency beyond NumPy (neither flax nor the `msgpack` package), and
`params_from_jax` maps the decoded {params, batch_stats, et} tree onto the
port's module names and `ETParams`.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

from .etspace.descriptor import ETBasis
from .etspace.facade import ETParams

# flax's msgpack extension types: an ndarray, packed [shape, dtype, bytes],
# and a numpy scalar, packed the same way with shape [].
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3


class _Reader:
    """A minimal msgpack decoder: maps, arrays, str/bin, ints, floats, nil,
    bool, and flax's ndarray and numpy-scalar extensions."""

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, self._take(size))[0]

    def read(self) -> Any:
        b = self._unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self._unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",     # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",     # str
                 0xDC: ">H", 0xDD: ">I",                 # array
                 0xDE: ">H", 0xDF: ">I",                 # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}     # ext
        if b in sized:
            n = self._unpack(sized[b])
            if b <= 0xC6:
                return bytes(self._take(n))
            if 0xD9 <= b <= 0xDB:
                return str(self._take(n), "utf-8")
            if b in (0xDC, 0xDD):
                return self._array(n)
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {self.pos - 1}")

    def _map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _ext(self, n: int):
        code = self._unpack(">b")
        data = bytes(self._take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack extension type {code}")
        shape, dtype, raw = _Reader(data).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == _EXT_NDARRAY else arr[()]


def read_flax_msgpack(path: str) -> Dict[str, Any]:
    """Decode a flax msgpack checkpoint into a nested dict of numpy arrays."""
    with open(path, "rb") as f:
        reader = _Reader(f.read())
    tree = reader.read()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{path}: trailing bytes after the msgpack object")
    return tree


# Leaf names of the JAX layers -> the port's parameter and buffer names.
_PARAM_NAMES = {"kernel": "weight", "bias": "bias", "scale": "weight", "alpha": "weight"}
_STAT_NAMES = {"mean": "running_mean", "var": "running_var"}


def _flatten(tree: Dict, names: Dict[str, str], prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, names, prefix + (key,))
        else:
            if key not in names:
                raise KeyError(f"no counterpart for leaf {'/'.join(prefix + (key,))}")
            if key == "kernel" and np.ndim(value) == 2:
                value = np.asarray(value).T      # linear (in, out) -> (out, in)
            yield ".".join(prefix + (names[key],)), value


def params_from_jax(tree: Dict[str, Any]) -> Tuple[Dict[str, torch.Tensor], ETParams]:
    """Map a decoded {params, batch_stats, et} tree onto the port.

    Returns a state dict for the predictor (conv `kernel` (already OIHW) ->
    `weight`, linear `kernel` (in, out) -> `weight` (out, in), transposed,
    BatchNorm `scale` -> `weight`, PReLU `alpha` -> `weight`,
    batch_stats `mean`/`var` -> `running_mean`/`running_var`) and the
    ETParams, all as CPU float tensors.
    """
    def t(x):
        return torch.from_numpy(np.array(x))

    state = {name: t(value) for name, value in _flatten(tree["params"], _PARAM_NAMES)}
    state.update((name, t(value)) for name, value in
                 _flatten(tree.get("batch_stats", {}), _STAT_NAMES))
    et = tree["et"]
    params = ETParams(
        basis_m=ETBasis(t(et["basis_m"]["U_obs"]), t(et["basis_m"]["U_pred"])),
        basis_s=ETBasis(t(et["basis_s"]["U_obs"]), t(et["basis_s"]["U_pred"])),
        anchor_m=t(et["anchor_m"]), anchor_s=t(et["anchor_s"]))
    return state, params
