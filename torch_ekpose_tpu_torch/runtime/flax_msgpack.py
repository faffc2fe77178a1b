"""A reader for flax's msgpack checkpoints, in pure Python.

The JAX package writes its native checkpoints (``cli.export``'s
``.msgpack``, ``runtime/checkpoint.py::save_checkpoint``) and its
trainer's ``.ckpt`` with ``flax.serialization``: one msgpack document of
nested maps whose array leaves are msgpack extension objects. The card
has neither flax nor msgpack, so this module decodes the format itself:

- msgpack's nil, booleans, integers, floats, str, bin, arrays and maps
  (big-endian, https://github.com/msgpack/msgpack/blob/master/spec.md);
- extension type 1, a numpy array: a nested msgpack ``(shape, dtype
  name, C-order bytes)``; ``bfloat16`` (which numpy does not have)
  becomes a ``torch.bfloat16`` tensor, a ``uint16`` view of the bytes;
- extension type 2, a complex scalar (a nested ``(real, imag)``), and
  type 3, a numpy scalar (an array of shape ``()``, unwrapped);
- flax's chunked arrays: a map with ``__msgpack_chunked_array__`` whose
  ``chunks`` ({"0": flat array, ...}) concatenate to ``shape`` (flax
  splits a leaf over ``MAX_CHUNK_SIZE`` = 2**30 bytes).

Every other array leaf comes back as a read-only numpy array over the
file's bytes (copy it to write it).
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

__all__ = ["read_flax_msgpack", "unpack"]

#: flax.serialization._MsgpackExtType
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
#: the key flax puts in a chunked leaf's map
CHUNKED = "__msgpack_chunked_array__"

_FIXED = {  # first byte -> (struct format, size) of a fixed-width scalar
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    """One pass over a msgpack buffer (a ``memoryview``)."""

    def __init__(self, data: memoryview, raw: bool = False):
        self.data = data
        self.pos = 0
        self.raw = raw      # str as bytes, as flax's nested array header

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def length(self, width: int) -> int:
        return struct.unpack(_LENGTH[width], self.take(width))[0]

    def text(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        return _ext(code, self.take(n))

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self.take(size))[0]
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):                 # bin 8/16/32
            return self.take(self.length(1 << (b - 0xC4)))
        if b in (0xC7, 0xC8, 0xC9):                 # ext 8/16/32
            return self.ext(self.length(1 << (b - 0xC7)))
        if 0xD4 <= b <= 0xD8:                       # fixext 1..16
            return self.ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):                 # str 8/16/32
            return self.text(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):                       # array 16/32
            return [self.value() for _ in range(self.length(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):                       # map 16/32
            return self.map(self.length(2 << (b - 0xDE)))
        raise ValueError(f"byte 0x{b:02x} at {self.pos - 1} is not msgpack")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def unpack(data, raw: bool = False) -> Any:
    """Decode one msgpack document (bytes-like); ``raw=True`` keeps str
    values as bytes."""
    reader = _Reader(memoryview(data), raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         "msgpack document")
    return out


def _array(payload: memoryview):
    """flax's ndarray encoding -> numpy, or torch for bfloat16."""
    shape, name, buffer = unpack(payload, raw=True)
    name = name.decode("ascii")
    if name == "bfloat16":
        flat = np.frombuffer(buffer, dtype=np.uint16)
        return torch.from_numpy(flat.copy()).view(torch.bfloat16).reshape(
            shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _array(payload)
    if code == EXT_COMPLEX:
        real, imag = unpack(payload)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        arr = _array(payload)
        return arr.reshape(()) if torch.is_tensor(arr) else arr[()]
    raise ValueError(f"msgpack extension type {code} is not flax's")


def _ordered(d: dict) -> Tuple:
    """flax's {"0": a, "1": b, ...} as a tuple."""
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree):
    """Chunked leaves (``flax.serialization._chunk``) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED):
        shape = _ordered(tree["shape"])
        chunks = _ordered(tree["chunks"])
        if torch.is_tensor(chunks[0]):
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str) -> Any:
    """The tree ``flax.serialization.msgpack_restore`` would return for
    the file at ``path``: nested dicts of numpy arrays (``torch.bfloat16``
    tensors for bfloat16 leaves), numpy scalars and Python values."""
    with open(path, "rb") as f:
        data = f.read()
    return _unchunk(unpack(data))
