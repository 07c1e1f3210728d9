"""A reader of the Flax msgpack checkpoints the JAX package writes.

``flax.serialization.to_bytes`` (the JAX ``save_checkpoint`` default)
writes a state dict as msgpack, with numpy arrays in msgpack's extension
types. This module decodes that subset in pure Python, so the port needs
no msgpack package:

- nil, bool, ints, float32/64, str, bin, arrays (as lists) and maps;
- ext type 1, an ndarray: a packed ``(shape, dtype name, C-order bytes)``
  (``flax/serialization.py`` ``_ndarray_to_bytes``); ext type 3, a numpy
  scalar in the same form; ext type 2, a Python complex as ``(real,
  imag)``;
- a ``{"__msgpack_chunked_array__": True, "shape", "chunks"}`` map, which
  flax writes for an array over its ``MAX_CHUNK_SIZE``, joined back into
  the array.

Arrays come back as read-only numpy arrays, as ``msgpack_restore`` gives
them, except ``bfloat16`` ones, which numpy has no dtype for: they are read
as uint16 and viewed as ``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw       # strings as bytes (flax reads the array
        #                      tuple's dtype name so)

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        raw = bytes(self.take(n))
        return raw if self.raw else raw.decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def value(self):
        b = self.unpack(">B")
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
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xC7: (">B", "ext"),
                 0xC8: (">H", "ext"), 0xC9: (">I", "ext"),
                 0xD9: (">B", "str"), 0xDA: (">H", "str"),
                 0xDB: (">I", "str"), 0xDC: (">H", "array"),
                 0xDD: (">I", "array"), 0xDE: (">H", "map"),
                 0xDF: (">I", "map")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.string(n)
            return getattr(self, kind)(n)
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if 0xD4 <= b <= 0xD8:   # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (b - 0xD4))
        raise ValueError(f"msgpack byte 0x{b:02x} is not supported")


def _unpackb(data: bytes, raw: bool = False):
    reader = _Reader(data, raw=raw)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the "
                         f"msgpack object")
    return out


def _ndarray(data: bytes):
    shape, dtype_name, buffer = _unpackb(data, raw=True)
    if dtype_name == b"bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.uint16)
        return flat.view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())
                         ).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == EXT_COMPLEX:
        real, imag = _unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack extension type {code} is not one flax writes")


def _unchunk(node):
    if not isinstance(node, dict):
        return node
    if CHUNKED in node:
        shape = tuple(node["shape"][str(i)] for i in range(len(node["shape"])))
        chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in node.items()}


def msgpack_restore(data: bytes):
    """The state dict of ``flax.serialization.to_bytes``'s output, as
    ``flax.serialization.msgpack_restore`` gives it (see the module)."""
    return _unchunk(_unpackb(data))


def is_flax_msgpack(path: str) -> bool:
    """Whether ``path`` starts as a flax state dict does: a msgpack map."""
    with open(path, "rb") as f:
        head = f.read(1)
    return len(head) == 1 and (0x80 <= head[0] <= 0x8F
                               or head[0] in (0xDE, 0xDF))
