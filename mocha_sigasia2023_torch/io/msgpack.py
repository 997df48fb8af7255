"""A reader of the JAX package's msgpack checkpoints, in Python and NumPy.

The JAX package writes its checkpoints with ``flax.serialization
.msgpack_serialize`` (mocha_sigasia2023_tpu/train/checkpoint.py:20-28).
This module decodes the msgpack subset that writer produces, with neither
``msgpack`` nor ``flax`` (the card's machine has neither):

- nil, bool, int, float, str, bin, array and map;
- ext type 1, an ndarray: a packed (shape, dtype name, C-order bytes);
- ext type 3, a NumPy scalar (packed as a 0-d ndarray);
- ext type 2, a Python complex: a packed (real, imag);
- flax's chunked form of large arrays, ``{"__msgpack_chunked_array__":
  True, "shape": ..., "chunks": ...}``, joined back into one array.

``bfloat16`` leaves, which NumPy cannot hold, come back as
``torch.bfloat16`` tensors (their bytes read as uint16); every other array
is a NumPy array.  Maps whose keys are exactly "0" .. "n-1" become lists
again, as ``restore_like`` rebuilds them from a template in JAX (flax turns
lists and tuples into such maps).  A truncated file, a type byte outside
the format and an unknown ext type raise ``ValueError`` naming the offset.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decodes one msgpack buffer; ``base`` is the buffer's offset in the
    file, so that errors inside an ext payload name the file's offset."""

    def __init__(self, buf, base: int = 0):
        self.buf = memoryview(buf)
        self.pos = 0
        self.base = base

    def fail(self, what: str, at: int):
        raise ValueError(f"msgpack: {what} at offset {self.base + at}")

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            self.fail(f"truncated: {n} bytes wanted, "
                      f"{len(self.buf) - self.pos} left", self.pos)
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "big")

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        at = self.pos
        t = self.uint(1)
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {
            0xC4: (1, self.bin), 0xC5: (2, self.bin), 0xC6: (4, self.bin),
            0xC7: (1, self.ext), 0xC8: (2, self.ext), 0xC9: (4, self.ext),
            0xD9: (1, self.str), 0xDA: (2, self.str), 0xDB: (4, self.str),
            0xDC: (2, self.array), 0xDD: (4, self.array),
            0xDE: (2, self.map), 0xDF: (4, self.map),
        }
        if t in sized:
            width, read = sized[t]
            return read(self.uint(width))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in fixed:
            return self.unpack(fixed[t])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        self.fail(f"unknown type byte 0x{t:02x}", at)

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        at = self.pos
        try:
            return str(self.take(n), "utf-8")
        except UnicodeDecodeError:
            self.fail("invalid UTF-8 string", at)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, n: int) -> Any:
        at = self.pos
        code = self.unpack(">b")
        payload_at = self.base + self.pos
        payload = self.take(n)
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            arr = _ndarray(payload, payload_at)
            return arr[()] if code == EXT_NPSCALAR else arr
        if code == EXT_COMPLEX:
            real, imag = _Reader(payload, payload_at).whole()
            return complex(real, imag)
        self.fail(f"unknown ext type {code}", at)

    def whole(self) -> Any:
        """The buffer's one value; trailing bytes raise."""
        out = self.value()
        if self.pos != len(self.buf):
            self.fail(f"{len(self.buf) - self.pos} trailing bytes", self.pos)
        return out


def _ndarray(payload, base: int):
    """flax's ndarray encoding: msgpack (shape, dtype name, C bytes)."""
    r = _Reader(payload, base)
    parts = r.whole()
    if not (isinstance(parts, list) and len(parts) == 3):
        r.fail("an ndarray payload that is not (shape, dtype, bytes)", 0)
    shape, name, data = parts
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = np.frombuffer(data, np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError:
        r.fail(f"unknown dtype {name!r}", 0)
    if len(data) != int(np.prod(shape, dtype=np.int64)) * dtype.itemsize:
        r.fail(f"{len(data)} bytes for a {name} array of shape {shape}", 0)
    return np.frombuffer(data, dtype).reshape(shape).copy()


def is_index_map(node: dict) -> bool:
    """Whether ``node`` is a map keyed exactly "0" .. "n-1" (n > 0): a
    list or tuple as flax's state dicts store it."""
    return bool(node) and all(isinstance(k, str) for k in node) and \
        sorted(node) == sorted(str(i) for i in range(len(node)))


def _restore(node):
    """Chunked arrays joined, "0".."n-1" maps turned into lists, bottom
    up."""
    if isinstance(node, list):
        return [_restore(v) for v in node]
    if not isinstance(node, dict):
        return node
    node = {k: _restore(v) for k, v in node.items()}
    if node.get(CHUNKED) is True:
        shape = tuple(node["shape"]) if node["shape"] else ()
        chunks = node["chunks"]
        if torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return _as_list(node)


def _as_list(node: dict):
    """``node`` as a list if it is an index map, else as it is."""
    if is_index_map(node):
        return [node[str(i)] for i in range(len(node))]
    return node


def listify(node):
    """Maps keyed "0".."n-1" made lists, bottom up: how every reader of
    the port returns flax's lists and tuples."""
    if isinstance(node, list):
        return [listify(v) for v in node]
    if not isinstance(node, dict):
        return node
    return _as_list({k: listify(v) for k, v in node.items()})


def unpack(data: bytes) -> Any:
    """The tree that flax's ``msgpack_restore`` gives for ``data``, with
    lists for its index-keyed maps."""
    return _restore(_Reader(data).whole())


def read_msgpack(path: str) -> Any:
    """A JAX package checkpoint (``*.msgpack``), decoded."""
    with open(path, "rb") as f:
        return unpack(f.read())
