"""The JAX package's checkpoint directories, read and written without flax or
msgpack.

Counterpart of ``save_checkpoint``, ``load_checkpoint``,
``load_opt_state`` and ``load_meta`` in
``page_segmentation_tpu/train/checkpoint.py``:

    <dir>/params.msgpack     the variables, as flax's msgpack_serialize writes them
    <dir>/opt_state.msgpack  optionally, the optimizer state (optax's state dict)
    <dir>/meta.json          architecture, n_classes, the training loop's counters

:func:`load_checkpoint` returns ``(variables, meta)`` with ``variables``
always holding a ``"params"`` tree of numpy arrays, the layout that
``models/bridge.py`` ``params_from_jax`` takes; :func:`save_checkpoint`
writes such a tree, so each package reads the other's checkpoints.

:func:`msgpack_restore` and :func:`msgpack_serialize` cover the subset of
msgpack that flax writes: maps, arrays, str, bin, nil, bool, ints, floats,
and flax's ext types (1: an ndarray as the msgpack triple (shape, dtype
name, row-major bytes); 2: a complex as (real, imag); 3: a numpy scalar,
packed as an ndarray), plus flax's chunked form of arrays over 1 GiB.  numpy
has no bfloat16, so a bfloat16 array comes back widened exactly to float32.
``train/optim.py`` maps the optimizer state to and from optax's state dict.
:class:`OrbaxCheckpointer` is the counterpart of the JAX package's
asynchronous, step-versioned Orbax checkpoints, in orbax's own layout
(``train/orbax_format.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np

from .orbax_format import finished_steps, read_step, write_step

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
MAX_CHUNK_SIZE = 2 ** 30  # bytes: flax splits larger arrays into chunks of this size

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


def _header(n: int, small: int, fix: int, wide: Tuple[Tuple[int, int, str], ...]) -> bytes:
    """A length header: ``fix | n`` below ``small``, else the first of
    ``wide`` = ((type byte, limit, struct format), ...) whose limit n is under."""
    if n < small:
        return bytes([fix | n])
    for byte, limit, fmt in wide:
        if n < limit:
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} does not fit msgpack")


_STR = ((0xD9, 1 << 8, ">B"), (0xDA, 1 << 16, ">H"), (0xDB, 1 << 32, ">I"))
_BIN = ((0xC4, 1 << 8, ">B"), (0xC5, 1 << 16, ">H"), (0xC6, 1 << 32, ">I"))
_ARRAY = ((0xDC, 1 << 16, ">H"), (0xDD, 1 << 32, ">I"))
_MAP = ((0xDE, 1 << 16, ">H"), (0xDF, 1 << 32, ">I"))
_EXT = ((0xC7, 1 << 8, ">B"), (0xC8, 1 << 16, ">H"), (0xC9, 1 << 32, ">I"))
_FIXEXT_BYTE = {n: byte for byte, n in _FIXEXT.items()}


def _pack_int(n: int) -> bytes:
    """msgpack's shortest form of an int, as the msgpack package writes it."""
    if 0 <= n < 0x80 or -0x20 <= n < 0:
        return struct.pack(">b" if n < 0 else ">B", n)
    widths = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if n > 0 else (
        (0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for byte, fmt in widths:
        try:
            return bytes([byte]) + struct.pack(fmt, n)
        except struct.error:
            continue
    raise OverflowError(f"{n} does not fit a 64-bit msgpack int")


def _pack_ext(code: int, data: bytes) -> bytes:
    if len(data) in _FIXEXT_BYTE:
        head = bytes([_FIXEXT_BYTE[len(data)]])
    else:
        head = _header(len(data), 0, 0, _EXT)
    return head + struct.pack(">b", code) + data


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return _packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def _pack(obj, out: list) -> None:
    """Append the msgpack bytes of ``obj`` to ``out``: msgpack's encoding
    with strict types (a float or int subclass, such as a numpy scalar, is
    not a float or int) and flax's ext types."""
    kind = type(obj)
    if obj is None:
        out.append(b"\xc0")
    elif kind is bool:
        out.append(b"\xc3" if obj else b"\xc2")
    elif kind is int:
        out.append(_pack_int(obj))
    elif kind is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif kind is str:
        data = obj.encode("utf-8")
        out += [_header(len(data), 32, 0xA0, _STR), data]
    elif kind is bytes:
        out += [_header(len(obj), 0, 0, _BIN), obj]
    elif kind in (list, tuple):
        out.append(_header(len(obj), 16, 0x90, _ARRAY))
        for item in obj:
            _pack(item, out)
    elif kind is dict:
        out.append(_header(len(obj), 16, 0x80, _MAP))
        for key, value in obj.items():
            _pack(key, out)
            _pack(value, out)
    elif isinstance(obj, np.ndarray):
        out.append(_pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj)))
    elif isinstance(obj, np.generic):
        out.append(_pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj))))
    elif kind is complex:
        out.append(_pack_ext(_EXT_COMPLEX, _packb((obj.real, obj.imag))))
    else:
        raise TypeError(f"cannot serialize {kind.__name__} to msgpack")


def _packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def _chunked(arr: np.ndarray):
    """flax's chunked form of an array above MAX_CHUNK_SIZE bytes."""
    if arr.nbytes <= MAX_CHUNK_SIZE:
        return arr
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True,
            "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _sorted(tree):
    """A copy with every dict's keys sorted, as flax's pytree copy makes."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def _chunk_leaves(tree):
    """Arrays chunked where flax chunks them: dict values and the top."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    return _chunked(tree) if isinstance(tree, np.ndarray) else tree


def msgpack_serialize(tree) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize`` writes for a tree
    of dicts, lists, Python scalars and numpy arrays (a tuple, which flax
    refuses there, is written as a list)."""
    return _packb(_chunk_leaves(_sorted(tree)))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree if tree is None else np.asarray(tree)


def save_checkpoint(path: str, variables, meta: Optional[Dict[str, Any]] = None,
                    opt_state=None) -> None:
    """Write ``variables`` (a collection dict with ``"params"``, or a bare
    params tree; numpy arrays or CPU tensors as leaves), ``opt_state`` (a
    state dict of such leaves, as ``Optimizer.state_dict`` gives it) and
    ``meta`` as the JAX package's ``save_checkpoint`` does: every leaf as an
    ndarray, so the same values give the same bytes."""
    if not isinstance(variables, dict) or "params" not in variables:
        variables = {"params": variables}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(msgpack_serialize(_to_numpy(dict(variables))))
    if opt_state is not None:
        with open(os.path.join(path, "opt_state.msgpack"), "wb") as f:
            f.write(msgpack_serialize(_to_numpy(opt_state)))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta or {}, f, indent=2, default=str)


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
    return variables, load_meta(path)


def _check_like(template, tree, where: str = "opt_state") -> None:
    """Raise unless ``tree`` has ``template``'s keys and array shapes."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where}: keys {got} do not match the template's {sorted(template)}")
        for key in template:
            _check_like(template[key], tree[key], f"{where}/{key}")
    elif np.shape(template) != np.shape(tree):
        raise ValueError(f"{where}: shape {np.shape(tree)} does not match the template's "
                         f"{np.shape(template)}")


def load_opt_state(path: str, template=None):
    """The optimizer state dict of a checkpoint directory, or None without
    one; with ``template`` (a state dict of the same optimizer) it must
    match the template's keys and shapes."""
    opt_file = os.path.join(path, "opt_state.msgpack")
    if not os.path.exists(opt_file):
        return None
    with open(opt_file, "rb") as f:
        state = msgpack_restore(f.read())
    if template is not None:
        _check_like(template, state)
    return state


def load_meta(path: str) -> Dict[str, Any]:
    """Only ``meta.json`` of a checkpoint directory ({} without one)."""
    meta_file = os.path.join(path, "meta.json")
    if not os.path.exists(meta_file):
        return {}
    with open(meta_file, "r") as f:
        return json.load(f)


class OrbaxCheckpointer:
    """Asynchronous, step-versioned training-state checkpoints: the
    counterpart of the JAX package's ``OrbaxCheckpointer`` (``save``,
    ``restore``, ``wait``, ``close``), in orbax's own layout, so each package
    reads the other's steps (``train/orbax_format.py``; the card's machine
    has no orbax):

        <directory>/<step>/state/   {"variables", "opt_state"}: orbax's
                                    StandardSave item (an OCDBT store of
                                    zarr v2 arrays)
        <directory>/<step>/meta/    the training loop's meta: a JsonSave item

    ``save`` copies the state on the caller's thread and writes it from a
    background thread under orbax's temporary name, renamed to the step's
    name when complete; then the oldest steps beyond ``max_to_keep`` are
    removed.  An error of that thread is raised by the next ``wait``.  In a
    run of several processes, the caller saves on the primary process only
    (``Trainer`` does), as with the JAX class's ``CheckpointManager``.
    """

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self):
        """The finished steps, oldest first."""
        return finished_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, variables, opt_state=None, meta: Optional[Dict] = None) -> None:
        """Start writing ``variables`` (and ``opt_state``, a state dict) as
        ``step``; a save still in flight finishes first."""
        self.wait()
        state = {"variables": _copied(dict(variables))}
        if opt_state is not None:
            state["opt_state"] = _copied(opt_state)
        meta = json.loads(json.dumps(meta or {}, default=str))

        def write():
            try:
                write_step(self.directory, step, state, meta)
                for old in self.all_steps()[: -self.max_to_keep] if self.max_to_keep else []:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
            except BaseException as exc:  # raised by the next wait()
                self._error = exc

        self._pending = threading.Thread(target=write, name="checkpoint-writer", daemon=True)
        self._pending.start()

    def restore(self, step: Optional[int] = None):
        """``(step, state, meta)`` of ``step`` (default: the newest), with
        ``state`` = ``{"variables": ..., "opt_state": ...}`` as orbax's
        ``StandardRestore`` gives it (no ``opt_state`` when none was saved);
        None without any step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        self.wait()
        state, meta = read_step(os.path.join(self.directory, str(int(step))))
        return int(step), state, meta

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def close(self) -> None:
        self.wait()


def _copied(tree):
    """A deep copy of a tree of arrays/tensors as numpy, safe from later
    in-place updates of the training state."""
    if isinstance(tree, dict):
        return {k: _copied(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_copied(v) for v in tree)
    if tree is None:
        return None
    if hasattr(tree, "detach"):
        tree = tree.detach().cpu()
        if str(tree.dtype) == "torch.bfloat16":  # numpy has no bfloat16
            return tree.clone()
        tree = tree.numpy()
    return np.array(tree, copy=True)
