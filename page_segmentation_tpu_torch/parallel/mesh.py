"""Device meshes in one process, and the data placed on them.

Counterpart of ``page_segmentation_tpu/parallel/mesh.py``.  A :class:`Mesh`
names a grid of devices, as ``jax.sharding.Mesh`` does:

* axis ``data``: data parallelism across pages;
* axis ``space``: the rows of one page split across devices, with halos
  exchanged between neighbours (``parallel/spatial.py``).

One process drives every device of its mesh: a shard is launched on its own
device from the host, one after another, and on several cards their work
overlaps because each card runs its own stream.  A collective is an explicit
tensor move: a halo is ``tensor.to(neighbour, non_blocking=True)`` (a peer
copy between cards), and :func:`psum` sums the shards' tensors onto the
first device.  A mesh that spans several processes (``parallel/distributed.py``
``global_mesh``) holds only its own process's devices as ``local_devices``;
:func:`psum` then adds one ``torch.distributed.all_reduce`` of a single
flattened buffer.

A sharded tensor is a list of tensors, one per shard, each on its shard's
device, in mesh order.  When the caller asks for the CPU, the CPU counts as
as many devices as asked for (the JAX tests' virtual CPU devices).
"""
from __future__ import annotations

import copy
import weakref
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


class Mesh:
    """A grid of devices with named axes.  ``devices`` is a numpy object array
    of ``torch.device`` (``devices.shape`` and ``devices.size`` read as in
    JAX); ``local_devices`` are the ones this process drives, in mesh order
    (all of them unless the mesh spans processes)."""

    def __init__(self, devices, axis_names: Sequence[str], process_index: int = 0,
                 process_count: int = 1):
        grid = np.empty(np.shape(devices), dtype=object)
        for index in np.ndindex(grid.shape):
            grid[index] = torch.device(np.asarray(devices, dtype=object)[index])
        if grid.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {grid.shape} needs {grid.ndim} axis names, "
                             f"got {tuple(axis_names)}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.process_index = process_index
        self.process_count = process_count

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> List[torch.device]:
        flat = list(self.devices.flat)
        n_local = len(flat) // self.process_count
        start = self.process_index * n_local
        return flat[start : start + n_local]

    def axis_devices(self, axis: str) -> List[torch.device]:
        """One device per index along ``axis`` (this process's part of it):
        the first of each slice along the other axes, where a shard of that
        axis runs (the others would hold replicas of its result)."""
        moved = np.moveaxis(self.devices, self.axis_names.index(axis), 0)
        firsts = list(moved.reshape(moved.shape[0], -1)[:, 0])
        n_local = len(firsts) // self.process_count
        return firsts[self.process_index * n_local : (self.process_index + 1) * n_local]

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, devices={[str(d) for d in self.devices.flat]})"


def _device_list(devices, n_devices: Optional[int]) -> List[torch.device]:
    if devices is None or isinstance(devices, (str, torch.device)):
        dev = resolve_device("cuda" if devices is None else devices)
        if dev.type == "cpu":
            return [dev] * (n_devices or 1)
        if dev.index is not None:
            return [dev]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",), devices=None) -> Mesh:
    """A mesh of ``n_devices`` (default: all) laid out as ``shape`` (default:
    all along the first axis).  ``devices``: a list (it may repeat a device,
    as ``jax.sharding.Mesh`` accepts), ``"cpu"`` (the CPU counts as
    ``n_devices`` devices), or None / ``"cuda"`` for every CUDA device."""
    if isinstance(devices, str) and devices == "cpu" and n_devices is None and shape is not None:
        n_devices = int(np.prod(shape))
    devices = _device_list(devices, n_devices)
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"Requested {n} devices, have {len(devices)}")
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = devices[: grid.size]
    return Mesh(grid.reshape(shape), tuple(axis_names))


class NamedSharding:
    """Rows of an array split along one mesh axis (``axis``), or the whole
    array on every device (``axis=None``)."""

    def __init__(self, mesh: Mesh, axis: Optional[str] = None):
        self.mesh = mesh
        self.axis = axis

    @property
    def devices(self) -> List[torch.device]:
        return self.mesh.axis_devices(self.axis) if self.axis else self.mesh.local_devices

    def chunks(self, arr) -> list:
        """``arr``'s pieces for :attr:`devices`, in mesh order; the leading
        dimension must divide by their count."""
        if self.axis is None:
            return [arr] * len(self.devices)
        n = len(self.devices)
        if arr.shape[0] % n:
            raise ValueError(f"leading dimension {arr.shape[0]} does not divide over the "
                             f"{n} devices of mesh axis '{self.axis}'")
        step = arr.shape[0] // n
        return [arr[i * step : (i + 1) * step] for i in range(n)]


def data_sharding(mesh: Mesh, axis: str = "data") -> NamedSharding:
    """Batch sharding: the leading dimension split across ``axis``."""
    return NamedSharding(mesh, axis)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, None)


def _to_device(arr, device: torch.device) -> torch.Tensor:
    tensor = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(arr))
    return tensor.to(device, non_blocking=True)


def shard_batch(mesh: Mesh, batch: dict, axis: str = "data",
                put: Optional[Callable] = None) -> dict:
    """Place a host batch (a dict of arrays with one leading dimension) on the
    mesh, split along ``axis``: each value becomes a list with one piece per
    device, in mesh order.  ``put(piece, device)`` places one piece (default:
    a copy to the device)."""
    sharding = data_sharding(mesh, axis)
    put = put or _to_device
    return {key: [put(piece, device) for piece, device in
                  zip(sharding.chunks(value), sharding.devices)]
            for key, value in batch.items()}


def psum(mesh: Mesh, per_shard: Sequence[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """Sum over the shards, for each position of ``per_shard[i]`` (shard i's
    tensors): the tensors are flattened into one float32 buffer per shard,
    the buffers summed onto the first shard's device in shard order, across
    processes by one ``all_reduce``, and split back to the tensors' shapes
    and dtypes on that device."""
    first = per_shard[0]
    device = first[0].device
    total = None
    for tensors in per_shard:
        flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
        flat = flat.to(device, non_blocking=True)
        total = flat if total is None else total + flat
    if mesh.process_count > 1:
        import torch.distributed as dist

        dist.all_reduce(total)
    out, offset = [], 0
    for t in first:
        out.append(total[offset : offset + t.numel()].view(t.shape).to(t.dtype))
        offset += t.numel()
    return out


class ModuleReplicas:
    """A module's copy on each device it is asked for: the module itself on
    its own device, elsewhere a deep copy whose parameters and buffers are
    refreshed whenever the module's change (each tensor's in-place version
    counter), so a shard runs the very forward of the single-device path."""

    def __init__(self, module: torch.nn.Module):
        self._module = weakref.ref(module)
        self._copies: Dict[torch.device, Tuple[tuple, torch.nn.Module]] = {}

    def on(self, device) -> torch.nn.Module:
        module = self._module()
        device = torch.device(device)
        tensors = list(module.named_parameters()) + list(module.named_buffers())
        home = tensors[0][1].device if tensors else device
        if device == home:
            return module
        key = tuple((id(t), t._version) for _, t in tensors)
        held = self._copies.get(device)
        if held is None:
            replica = copy.deepcopy(module).to(device)
        elif held[0] != key:
            replica = held[1]
            with torch.no_grad():
                own = dict(list(replica.named_parameters()) + list(replica.named_buffers()))
                for name, t in tensors:
                    own[name].copy_(t, non_blocking=True)
        else:
            return held[1]
        replica.train(module.training)
        self._copies[device] = (key, replica)
        return replica


_REPLICAS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # module -> its replicas


def replicas_of(module: torch.nn.Module) -> ModuleReplicas:
    """The :class:`ModuleReplicas` of ``module``, kept while the module lives."""
    held = _REPLICAS.get(module)
    if held is None:
        held = _REPLICAS[module] = ModuleReplicas(module)
    return held
