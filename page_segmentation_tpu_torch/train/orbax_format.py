"""orbax's step directories, read and written without orbax or tensorstore.

Port-only module.  Its counterparts are orbax-checkpoint's
``StandardCheckpointHandler`` and ``JsonCheckpointHandler`` (the items
``state`` and ``meta`` that the JAX package's ``OrbaxCheckpointer`` saves
through a ``CheckpointManager``) and tensorstore's OCDBT key-value store
("optionally-cooperative distributed B+tree") with its zarr v2 arrays, in
the on-disk format of tensorstore 0.1.80 under orbax-checkpoint 0.11.32:

    <step>/_CHECKPOINT_METADATA        JSON naming the two item handlers
    <step>/meta/metadata               the meta dict as JSON
    <step>/state/_METADATA             JSON: each leaf's path and value type
    <step>/state/manifest.ocdbt        the OCDBT store's root manifest
    <step>/state/d/<file>              B+tree nodes and values
    <step>/state/ocdbt.process_<i>/    a process's own store (JAX-written
                                       steps); the root tree references its
                                       data files
    <step>/state/_sharding, array_metadatas/
                                       device layout of ``jax.Array`` leaves;
                                       not read, not written

The store's keys are zarr v2 arrays, one per leaf, named by the leaf's
dotted path: ``<name>/.zarray`` (JSON) and ``<name>/<i>.<j>...`` (a chunk in C
order, zstd-compressed; ``0`` for a scalar).

Manifests and nodes start with a magic number (``0x0cdb3a2a``,
``0x0cdb20de``, big-endian), their length (u64), a format version and a
compression (varints, 0 and 1 = zstd), then the body, then the CRC-32C of
all that precedes it.  Integers in a body are LEB128 varints unless stated.
A manifest body holds the store's config, a data-file table and the version
tree's newest entries, column by column; the newest version names the root
node.  A node holds its height, a data-file table and its entries column by
column, keys prefix-compressed against the entry before; a leaf's values are
inline or (data file, offset, length) references, an interior node's
entries reference child nodes that drop the first
``subtree_common_prefix_length`` bytes of their keys.

What is assumed of other versions: a step that orbax writes without OCDBT
(plain zarr directories), with zarr3, a "numbered" manifest, or a
compressor other than zstd is refused with an error naming it; the older
versions of the version tree are never read (only the newest matters).
orbax's ``_sharding`` is ignored, so a step written on devices that do not
exist here (a TPU's) reads all the same.

The writer makes what orbax and tensorstore read back: one root store under
``state/`` (the config that orbax gives tensorstore: zstd, inline values up
to 1024 bytes, nodes up to 100,000,000 bytes), one leaf node and one data
file, every leaf ``np.ndarray``-typed so that a step names no device, and
zstd frames of raw blocks (no compression: float32 weights barely compress).
A step is written under orbax's temporary name ``<step>.orbax-checkpoint-tmp``
and renamed when complete, so neither package takes half a step for a step.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import time
import uuid
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

TMP_SUFFIX = ".orbax-checkpoint-tmp"
_MANIFEST_MAGIC, _NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_ZSTD_BLOCK = 128 * 1024
_NO_NODE = 2 ** 64 - 1  # the offset and length of an empty tree's root
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
_HANDLERS = {
    "meta": "orbax.checkpoint._src.handlers.json_checkpoint_handler.JsonCheckpointHandler",
    "state": "orbax.checkpoint._src.handlers.standard_checkpoint_handler"
             ".StandardCheckpointHandler",
}
# key_type of orbax's tree metadata
_SEQUENCE_KEY, _DICT_KEY = 1, 2
# numpy's zarr v2 dtype strings, and tensorstore's name for bfloat16
_BFLOAT16 = "bfloat16"


# ------------------------------------------------------------------ zstd
def zstd_frame(data) -> bytes:
    """``data`` as one zstd frame of raw blocks (≤ 128 KiB each) with its
    content size in the header: valid for every zstd decoder, uncompressed."""
    view = memoryview(data).cast("B")
    n = len(view)
    if n < 256:  # single segment, content size in 1 byte
        header = _ZSTD_MAGIC + bytes([0x20, n])
    elif n < 65536 + 256:
        header = _ZSTD_MAGIC + bytes([0x60]) + struct.pack("<H", n - 256)
    elif n < 2 ** 32:
        header = _ZSTD_MAGIC + bytes([0xA0]) + struct.pack("<I", n)
    else:
        header = _ZSTD_MAGIC + bytes([0xE0]) + struct.pack("<Q", n)
    parts = [header]
    for start in range(0, max(n, 1), _ZSTD_BLOCK):
        size = min(_ZSTD_BLOCK, n - start)
        last = start + _ZSTD_BLOCK >= n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))  # raw block
        parts.append(view[start : start + size])
    return b"".join(parts)


def _zstd_decompress(data, out=None):
    from ..native import zstd_decompress

    return zstd_decompress(data, out=out)


def _crc32c(data) -> int:
    from ..native import crc32c

    return crc32c(data)


# ---------------------------------------------------------------- varints
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        byte = n & 0x7F
        n >>= 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


class _Body:
    """A cursor over a decoded manifest or node body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ValueError(f"OCDBT {self.what}: truncated")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint longer than 64 bits")
            b = self.byte()
            value |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def data_file_table(self) -> List[str]:
        """Paths of the data files, relative to the store's directory."""
        n = self.varint()
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        base = self.varints(n)
        paths, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise ValueError(f"OCDBT {self.what}: corrupt data file table")
            full = prev[: prefix[i]] + self.take(suffix[i])
            if base[i] > len(full):
                raise ValueError(f"OCDBT {self.what}: corrupt data file table")
            prev = full
            path = full.decode()
            parts = path.split("/")
            if path.startswith("/") or ".." in parts:
                raise ValueError(f"OCDBT {self.what}: data file {path!r} leaves the store")
            paths.append(path)
        return paths

    def keys(self, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
        prefix = [0] + self.varints(n - 1) if n else []
        suffix = self.varints(n)
        common = self.varints(n) if interior else [0] * n
        keys, prev = [], b""
        for i in range(n):
            if prefix[i] > len(prev):
                raise ValueError(f"OCDBT {self.what}: corrupt key prefix")
            prev = prev[: prefix[i]] + self.take(suffix[i])
            keys.append(prev)
        return keys, common


def _unwrap(raw: bytes, magic: int, what: str) -> bytes:
    """The decoded body of a manifest or node file, its CRC checked."""
    if len(raw) < 18 or struct.unpack(">I", raw[:4])[0] != magic:
        raise ValueError(f"OCDBT {what}: bad magic number")
    if struct.unpack("<Q", raw[4:12])[0] != len(raw):
        raise ValueError(f"OCDBT {what}: length field {struct.unpack('<Q', raw[4:12])[0]} "
                         f"!= {len(raw)} bytes")
    if _crc32c(memoryview(raw)[:-4]) != struct.unpack("<I", raw[-4:])[0]:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    head = _Body(raw[12:-4], what)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"OCDBT {what}: format version {version} is not supported")
    body = raw[12 + head.pos : -4]
    if compression == 1:
        return _zstd_decompress(body)
    if compression != 0:
        raise ValueError(f"OCDBT {what}: compression {compression} is not supported")
    return body


def _wrap(body: bytes, magic: int) -> bytes:
    payload = bytes([0, 1]) + zstd_frame(body)  # version 0, zstd
    head = struct.pack(">I", magic) + struct.pack("<Q", 12 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", _crc32c(data))


# ----------------------------------------------------------- OCDBT reader
class _Files:
    """The store's data files, each read once."""

    def __init__(self, root: str):
        self.root, self.cache = root, {}

    def get(self, path: str, offset: int, length: int) -> memoryview:
        if path not in self.cache:
            full = os.path.join(self.root, *path.split("/"))
            with open(full, "rb") as f:
                self.cache[path] = memoryview(f.read())
        data = self.cache[path]
        if offset + length > len(data):
            raise ValueError(f"OCDBT: reference past the end of {path}")
        return data[offset : offset + length]


def read_ocdbt(directory: str) -> Dict[bytes, memoryview]:
    """Every key and value of the OCDBT store in ``directory``, as of its
    newest version."""
    with open(os.path.join(directory, "manifest.ocdbt"), "rb") as f:
        body = _Body(_unwrap(f.read(), _MANIFEST_MAGIC, "manifest"), "manifest")
    body.take(16)  # the store's uuid
    kind = body.varint()
    if kind != 0:
        raise ValueError(f"OCDBT manifest kind {kind} (numbered) is not supported")
    body.varint(), body.varint(), body.byte()  # max inline, max node bytes, arity
    if body.varint() == 1:
        body.take(4)  # zstd level
    files = body.data_file_table()
    n = body.varint()
    if n == 0:
        return {}
    body.varints(n)  # generation numbers
    heights = list(body.take(n))
    columns = [body.varints(n) for _ in range(6)]
    file_id, offset, length = (c[-1] for c in columns[:3])
    out: Dict[bytes, memoryview] = {}
    if offset == _NO_NODE:
        return out
    if file_id >= len(files):
        raise ValueError("OCDBT manifest: root node in an unknown data file")
    store = _Files(directory)
    _read_node(store, files[file_id], offset, length, heights[-1], b"", out)
    return out


def _read_node(store: _Files, path: str, offset: int, length: int, height: int,
               prefix: bytes, out: Dict[bytes, memoryview]) -> None:
    body = _Body(_unwrap(bytes(store.get(path, offset, length)), _NODE_MAGIC, "node"), "node")
    if body.byte() != height:
        raise ValueError("OCDBT node: height differs from its reference")
    files = body.data_file_table()
    n = body.varint()
    keys, common = body.keys(n, interior=height > 0)

    def file_of(i):
        if i >= len(files):
            raise ValueError("OCDBT node: reference to an unknown data file")
        return files[i]

    if height == 0:
        lengths = body.varints(n)
        kinds = body.varints(n)
        indirect = [i for i in range(n) if kinds[i] == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError("OCDBT node: unknown value kind")
        ids, offsets = body.varints(len(indirect)), body.varints(len(indirect))
        for i in range(n):
            if kinds[i] == 0:
                out[prefix + keys[i]] = memoryview(body.take(lengths[i]))
        for j, i in enumerate(indirect):
            out[prefix + keys[i]] = store.get(file_of(ids[j]), offsets[j], lengths[i])
    else:
        ids, offsets, lengths = body.varints(n), body.varints(n), body.varints(n)
        for _ in range(3):
            body.varints(n)  # per subtree: keys, tree bytes, indirect value bytes
        for i in range(n):
            if common[i] > len(keys[i]):
                raise ValueError("OCDBT node: corrupt subtree prefix")
            _read_node(store, file_of(ids[i]), offsets[i], lengths[i], height - 1,
                       prefix + keys[i][: common[i]], out)
    if body.pos != len(body.data):
        raise ValueError("OCDBT node: bytes after its entries")


# ----------------------------------------------------------- OCDBT writer
def write_ocdbt(directory: str, items: Dict[str, Any]) -> None:
    """A new OCDBT store in ``directory`` holding ``items`` (key → bytes):
    one root manifest, one leaf node and one data file (values over 1024
    bytes, then the node)."""
    if not items:
        raise ValueError("an OCDBT store needs at least one key")
    keys = sorted((k.encode(), v) for k, v in items.items())
    data_name = "d/" + uuid.uuid4().hex
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    lengths, kinds, offsets, inline, indirect_bytes = [], [], [], [], 0
    with open(os.path.join(directory, *data_name.split("/")), "wb") as f:
        for _, value in keys:
            n = memoryview(value).nbytes
            lengths.append(n)
            if n > MAX_INLINE_VALUE_BYTES:
                kinds.append(1)
                offsets.append(f.tell())
                f.write(value)
                indirect_bytes += n
            else:
                kinds.append(0)
                inline.append(bytes(value))
        node_offset = f.tell()
        table = _data_file_table([data_name] if offsets else [])
        raw = [k for k, _ in keys]
        prefix = [_common_prefix(raw[i - 1], raw[i]) for i in range(1, len(raw))]
        body = b"".join([
            bytes([0]),  # height: a leaf
            table,
            _varint(len(raw)),
            *map(_varint, prefix),
            *(_varint(len(k) - p) for k, p in zip(raw, [0] + prefix)),
            *(k[p:] for k, p in zip(raw, [0] + prefix)),
            *map(_varint, lengths),
            *map(_varint, kinds),
            *(_varint(0) for _ in offsets),  # data file 0
            *map(_varint, offsets),
            *inline,
        ])
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"OCDBT leaf of {len(body)} bytes > {MAX_DECODED_NODE_BYTES}")
        node = _wrap(body, _NODE_MAGIC)
        f.write(node)
    manifest = b"".join([
        uuid.uuid4().bytes,
        _varint(0),  # manifest kind: single
        _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES),
        bytes([4]),  # version tree arity log2
        _varint(1), struct.pack("<i", 0),  # zstd, level 0
        _data_file_table([data_name]),
        _varint(1),  # one version
        _varint(1),  # generation 1
        bytes([0]),  # root height
        _varint(0), _varint(node_offset), _varint(len(node)),
        _varint(len(raw)), _varint(len(node)), _varint(indirect_bytes),
        struct.pack("<Q", time.time_ns()),
        _varint(0),  # no version tree nodes
    ])
    with open(os.path.join(directory, "manifest.ocdbt"), "wb") as f:
        f.write(_wrap(manifest, _MANIFEST_MAGIC))


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _data_file_table(paths: List[str]) -> bytes:
    raw = [p.encode() for p in paths]
    prefix = [_common_prefix(raw[i - 1], raw[i]) for i in range(1, len(raw))]
    return b"".join([
        _varint(len(raw)),
        *map(_varint, prefix),
        *(_varint(len(p) - q) for p, q in zip(raw, [0] + prefix)),
        *(_varint(0) for _ in raw),  # base path: the store's own directory
        *(p[q:] for p, q in zip(raw, [0] + prefix)),
    ])


# ------------------------------------------------------------------- zarr
def _numpy_dtype(name: str) -> np.dtype:
    if name == _BFLOAT16:
        return np.dtype("<u2")
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"zarr dtype {name!r} is not supported") from None
    if dtype.kind not in "biuf":
        raise ValueError(f"zarr dtype {name!r} is not supported")
    return dtype


def _fill(value, name: str):
    """The fill value in the array's storage dtype (bfloat16 as its bits)."""
    if value is None:
        return 0
    if isinstance(value, str):  # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    if name != _BFLOAT16:
        return value
    if np.isnan(value):
        return 0x7FC0
    bits = int(np.float32(value).view(np.uint32))
    return (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16  # round to nearest even


def decode_zarr(zarray: bytes, chunk: Callable[[str], Optional[bytes]]):
    """The array that a ``.zarray`` describes; ``chunk(key)`` gives a
    chunk's stored bytes or None.  bfloat16 comes back as a torch tensor
    (numpy has no bfloat16), every other dtype as a numpy array."""
    meta = json.loads(bytes(zarray))
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr format {meta.get('zarr_format')} is not supported")
    if meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError("zarr arrays in Fortran order or with filters are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"zarr compressor {compressor.get('id')!r} is not supported")
    dtype = _numpy_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr chunks {chunks} do not fit shape {shape}")
    sep = meta.get("dimension_separator", ".")
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    expected = int(np.prod(chunks, dtype=np.int64)) * dtype.itemsize
    whole = shape == chunks  # one chunk: decoded in place, no copy
    out = None if whole else np.full(shape, _fill(meta.get("fill_value"), meta["dtype"]), dtype)
    for index in np.ndindex(*grid):
        data = chunk(sep.join(map(str, index)) if index else "0")
        if data is None:
            continue
        if compressor is not None:
            raw = _zstd_decompress(data, out=np.empty(expected, np.uint8))
        else:
            raw = np.frombuffer(data, np.uint8).copy()
            if raw.size != expected:
                raise ValueError(f"zarr chunk {index} holds {raw.size} bytes, not {expected}")
        block = raw.view(dtype).reshape(chunks)
        if whole:
            out = block
            continue
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = block[tuple(slice(0, r.stop - r.start) for r in region)]
    if out is None:  # the one chunk is missing
        out = np.full(shape, _fill(meta.get("fill_value"), meta["dtype"]), dtype)
    if meta["dtype"] == _BFLOAT16:
        import torch

        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def encode_zarr(array) -> Tuple[bytes, bytes, str]:
    """``(.zarray text, chunk bytes, chunk key)`` of one array in one chunk,
    as orbax writes them (the text byte for byte; the chunk as raw zstd
    blocks)."""
    if hasattr(array, "detach"):  # a torch tensor
        import torch

        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            data, name, shape = t.view(torch.int16).numpy(), _BFLOAT16, tuple(t.shape)
        else:
            data = t.numpy()
            name, shape = data.dtype.str, data.shape
    else:
        data = np.asarray(array)
        name, shape = data.dtype.str, data.shape
    _numpy_dtype(name)
    if name.startswith(">"):
        data = data.astype(data.dtype.newbyteorder("<"))
        name = data.dtype.str
    meta = {
        "chunks": [max(int(s), 1) for s in shape],
        "compressor": {"id": "zstd", "level": 1},
        "dimension_separator": ".",
        "dtype": name,
        "fill_value": None,
        "filters": None,
        "order": "C",
        "shape": [int(s) for s in shape],
        "zarr_format": 2,
    }
    text = json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()
    key = ".".join("0" for _ in shape) if shape else "0"
    if not data.flags.c_contiguous:  # (np.ascontiguousarray would make a scalar 1-d)
        data = data.copy(order="C")
    return text, zstd_frame(data), key


# ------------------------------------------------------ the state and meta
def _leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(path, leaf) pairs, a path being (key, key_type) pairs; an empty
    dict, an empty list and None are leaves."""
    if isinstance(tree, dict) and tree:
        for key in sorted(tree, key=str):
            yield from _leaves(tree[key], path + ((str(key), _DICT_KEY),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, value in enumerate(tree):
            yield from _leaves(value, path + ((str(i), _SEQUENCE_KEY),))
    else:
        yield path, tree


def write_state(directory: str, tree: dict) -> None:
    """``tree`` (nested dicts and lists of arrays, tensors or Python
    scalars) as orbax's ``StandardSave`` item in ``directory``."""
    items, metadata = {}, {}
    for path, leaf in _leaves(tree):
        if not path:
            raise ValueError("the state must be a non-empty dict or list")
        names = [k for k, _ in path]
        entry = {"key_metadata": [{"key": k, "key_type": t} for k, t in path]}
        if leaf is None or isinstance(leaf, (dict, list, tuple)):
            kind = "None" if leaf is None else "Dict" if isinstance(leaf, dict) else "List"
            entry["value_metadata"] = {"value_type": kind, "skip_deserialize": True}
        else:
            scalar = isinstance(leaf, (bool, int, float))
            text, chunk, key = encode_zarr(np.asarray(leaf) if scalar else leaf)
            name = ".".join(names)
            items[f"{name}/.zarray"] = text
            items[f"{name}/{key}"] = chunk
            entry["value_metadata"] = {"value_type": "scalar" if scalar else "np.ndarray",
                                       "skip_deserialize": False}
        metadata[str(tuple(names))] = entry
    os.makedirs(directory, exist_ok=True)
    write_ocdbt(directory, items)
    with open(os.path.join(directory, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": metadata, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)


def read_state(directory: str) -> dict:
    """orbax's ``StandardRestore`` of the item in ``directory`` without a
    target: nested dicts (keys as strings, digits too) and lists, numpy
    arrays (bfloat16 as torch tensors), Python scalars for ``scalar``
    leaves."""
    with open(os.path.join(directory, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError("only OCDBT steps with zarr v2 arrays are supported "
                         f"(use_ocdbt={meta.get('use_ocdbt')}, use_zarr3={meta.get('use_zarr3')})")
    store = read_ocdbt(directory)
    root: Any = None
    for entry in meta["tree_metadata"].values():
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        kind = entry["value_metadata"]["value_type"]
        if kind in ("None", "Dict", "List"):
            value = None if kind == "None" else {} if kind == "Dict" else []
        else:
            name = ".".join(k for k, _ in path)
            zarray = store.get(f"{name}/.zarray".encode())
            if zarray is None:
                raise ValueError(f"orbax step: no array {name!r} in {directory}")
            value = decode_zarr(zarray, lambda key: store.get(f"{name}/{key}".encode()))
            if kind == "scalar":
                value = value.item()
        root = _insert(root, path, value)
    return _as_lists(root) if root is not None else {}


def _insert(node, path, value):
    if not path:
        return value
    (key, kind), rest = path[0], path[1:]
    if node is None:
        node = {}
    node[(kind, key)] = _insert(node.get((kind, key)), rest, value)
    return node


def _as_lists(node):
    """The (key_type, key) dicts of :func:`_insert` as orbax restores them:
    a sequence's children as a list in index order, a dict's by key."""
    if not isinstance(node, dict) or not node:
        return node
    if all(kind == _SEQUENCE_KEY for kind, _ in node):
        return [_as_lists(node[k]) for k in sorted(node, key=lambda k: int(k[1]))]
    return {key: _as_lists(v) for (_, key), v in node.items()}


def write_step(directory: str, step: int, state: dict, meta: dict) -> str:
    """One finished step ``<directory>/<step>/`` of a ``CheckpointManager``
    with the items ``state`` and ``meta``; returns its path."""
    final = os.path.join(directory, str(int(step)))
    tmp = final + TMP_SUFFIX
    shutil.rmtree(tmp, ignore_errors=True)
    started = time.time_ns()
    try:
        write_state(os.path.join(tmp, "state"), state)
        os.makedirs(os.path.join(tmp, "meta"))
        with open(os.path.join(tmp, "meta", "metadata"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "_CHECKPOINT_METADATA"), "w") as f:
            json.dump({"item_handlers": _HANDLERS, "metrics": {}, "performance_metrics": {},
                       "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                       "custom_metadata": {}}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def read_step(path: str) -> Tuple[dict, dict]:
    """``(state, meta)`` of the finished step directory ``path``."""
    state = read_state(os.path.join(path, "state"))
    meta_file = os.path.join(path, "meta", "metadata")
    meta = {}
    if os.path.exists(meta_file):
        with open(meta_file) as f:
            meta = json.load(f)
    return state, meta


def finished_steps(directory: str) -> List[int]:
    """The steps of ``directory`` that are complete, oldest first: integer
    names (a step being written carries orbax's temporary suffix)."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name) for name in os.listdir(directory)
                  if name.isdigit() and os.path.isdir(os.path.join(directory, name)))
