"""A reader of Flax msgpack files, written by hand: the card's machine has
neither ``msgpack`` nor ``flax``.

It reads what ``flax.serialization.to_bytes`` / ``msgpack_serialize``
write: JAX's ``train/checkpoint.py`` ``save_params`` (a training run's
``params_latest.msgpack``) and the pretrained cache
``<variant>_flax.msgpack``. :func:`msgpack_restore` returns what
``flax.serialization.msgpack_restore`` returns: nested dicts (string keys)
with numpy arrays at the leaves, the input of :mod:`.from_jax`. A
``bfloat16`` leaf, which numpy has no dtype for, comes out as a
``torch.bfloat16`` tensor with the same bits.

The wire format (all multi-byte fields big-endian): nil, bool, the fixed
and sized ints, float32 and float64, str and bin (distinct types), array
and map in all their widths, ext and fixext. Flax's ext types: 1 an
ndarray, whose payload is itself msgpack ``[shape, dtype name, raw bytes]``
in C order; 2 a Python complex (``[real, imag]``); 3 a numpy scalar (an
ndarray payload of shape ``[]``). A leaf over ``MAX_CHUNK_SIZE`` bytes was
written as a dict ``{"__msgpack_chunked_array__": True, "shape": {"0":
...}, "chunks": {"0": ...}}`` of flat chunks, and is joined back. A tuple
in a Flax tree is a dict keyed ``"0"``, ``"1"``, ...; it stays one. An ext
type Flax does not use comes back as an :class:`ExtType`.
"""

from __future__ import annotations

import struct
from typing import Any, NamedTuple

import numpy as np
import torch

CHUNKED_KEY = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    code: int
    data: bytes


def _leaf_from_bytes(data) -> Any:
    """Flax's ndarray payload ``[shape, dtype name, raw bytes]``."""
    shape, dtype, buf = _Reader(data).read_all()
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape, order="C")
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape,
                                                             order="C")


def _ext(code: int, data: memoryview) -> Any:
    if code == 1:
        return _leaf_from_bytes(data)
    if code == 2:
        real, imag = _Reader(data).read_all()
        return complex(real, imag)
    if code == 3:
        return _leaf_from_bytes(data)[()]
    return ExtType(code, bytes(data))


class _Reader:
    """One msgpack object from a buffer, decoded recursively."""

    def __init__(self, data):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(need {n} of {len(self.buf) - self.pos})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read_all(self) -> Any:
        obj = self.read()
        if self.pos != len(self.buf):
            raise ValueError(f"msgpack: {len(self.buf) - self.pos} bytes "
                             f"after the object")
        return obj

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _str(self, n: int) -> str:
        return bytes(self._take(n)).decode("utf-8")

    def _ext(self, n: int) -> Any:
        code = self._unpack(">b")
        return _ext(code, self._take(n))

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        u = self._unpack
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self._take(u({0xC4: ">B", 0xC5: ">H",
                                       0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            return self._ext(u({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b]))
        if b == 0xCA:
            return u(">f")
        if b == 0xCB:
            return u(">d")
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in ints:
            return u(ints[b])
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self._ext(1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return self._str(u({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]))
        if b in (0xDC, 0xDD):
            return self._array(u(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self._map(u(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: byte 0x{b:02x} at {self.pos - 1} starts "
                         f"no object")


def _by_index(d: dict) -> list:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED_KEY):
        chunks = _by_index(tree["chunks"])
        shape = tuple(_by_index(tree["shape"]))
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data) -> Any:
    """Decode Flax msgpack bytes into nested dicts of arrays."""
    return _unchunk(_Reader(data).read_all())


def read_msgpack(path) -> Any:
    """:func:`msgpack_restore` of a file."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
