"""Reading the JAX package's checkpoint directories, without flax or msgpack.

Counterpart of the read half of ``page_segmentation_tpu/train/checkpoint.py``:

    <dir>/params.msgpack   the variables, written by flax's msgpack_serialize
    <dir>/meta.json        architecture, n_classes, ...

:func:`load_checkpoint` returns ``(variables, meta)`` with ``variables``
always holding a ``"params"`` tree of numpy arrays, the layout that
``models/bridge.py`` ``params_from_jax`` takes.

:func:`msgpack_restore` decodes the subset of msgpack that flax writes:
maps, arrays, str, bin, nil, bool, ints, floats, and flax's ext types (1: an
ndarray as the msgpack triple (shape, dtype name, row-major bytes); 2: a
complex as (real, imag); 3: a numpy scalar, packed as an ndarray), plus
flax's chunked form of arrays over 1 GiB.  numpy has no bfloat16, so a
bfloat16 array comes back widened exactly to float32.  Saving, and the
optimizer state, come with training (ROADMAP queue 1 item 11).
"""
from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"

# fixed-size scalars: first byte -> struct format (big-endian)
_SCALARS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
# length-prefixed bodies: first byte -> (kind, length format)
_SIZED = {0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
          0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I")}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.value() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _SCALARS:
            return self.unpack(_SCALARS[b])
        if b in _FIXEXT:
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(_FIXEXT[b])))
        if b in _SIZED:
            kind, fmt = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            code = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the subset flax writes")

    def _map(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unpack_all(data: bytes):
    reader = _Reader(data)
    value = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack object")
    return value


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _unpack_all(data)
    if dtype_name == "bfloat16":  # the upper half of a float32's bits
        bits = np.frombuffer(buffer, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, np.dtype(dtype_name)).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _unpack_all(data)
        return complex(real, imag)
    raise ValueError(f"msgpack ext type {code} is not one that flax writes")


def _unchunk(tree):
    """flax's chunked arrays ({'__msgpack_chunked_array__', 'shape',
    'chunks'}) back to arrays, anywhere in the tree."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes):
    """The tree that ``flax.serialization.msgpack_serialize`` encoded: dicts,
    lists (flax's tuples come back as lists, as with flax's own restore),
    Python scalars and numpy arrays."""
    return _unchunk(_unpack_all(encoded))


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(variables, meta) of a checkpoint directory; ``variables`` always
    has a ``"params"`` key."""
    params_file = os.path.join(path, "params.msgpack")
    if not os.path.exists(params_file):
        raise FileNotFoundError(f"No checkpoint at {path}")
    with open(params_file, "rb") as f:
        variables = msgpack_restore(f.read())
    if "params" not in variables:  # a bare params tree
        variables = {"params": variables}
    meta = {}
    meta_file = os.path.join(path, "meta.json")
    if os.path.exists(meta_file):
        with open(meta_file, "r") as f:
            meta = json.load(f)
    return variables, meta
