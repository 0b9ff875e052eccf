"""Several processes: the bootstrap and the cross-process data plumbing.

Counterpart of ``page_segmentation_tpu/parallel/distributed.py``, on
``torch.distributed``.  Each process calls :func:`initialize` (a process
group over the coordinator at ``tcp://host:port``: NCCL for CUDA devices,
gloo for the CPU); :func:`global_mesh` then spans every process's local
devices, and the data-parallel steps of ``train/steps.py`` run on it as on
an in-process mesh: each process runs its own shards, and every cross-shard
sum adds one ``all_reduce`` of a single flattened buffer
(``parallel/mesh.py`` ``psum``).

The arguments default to the launcher's environment, as ``torchrun`` sets
it: ``MASTER_ADDR``:``MASTER_PORT`` for ``JAX_COORDINATOR_ADDRESS``,
``WORLD_SIZE`` for ``JAX_NUM_PROCESSES``, ``RANK`` for ``JAX_PROCESS_ID``
(and ``LOCAL_RANK``, where set, picks the process's card).

Data feeding is process-local: each process loads only the rows its own
devices consume (:func:`local_shard`) and places them on its devices
(:func:`global_batch`).
"""
from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from .mesh import Mesh, shard_batch

# this process's devices, set by initialize()
_local_devices: List[torch.device] = []


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


_rank = process_index


def local_devices() -> List[torch.device]:
    """The devices this process drives (every card until :func:`initialize`
    names them; without a card that raises)."""
    if _local_devices:
        return list(_local_devices)
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
    initialization_timeout: int = 600,
    heartbeat_timeout_seconds: int = 600,
    device="cuda",
) -> None:
    """Join the process group.  ``coordinator_address`` is ``host:port``
    (default ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.
    ``local_device_ids``: this process's card indices (default
    ``[LOCAL_RANK]`` where the launcher sets it, else every card); on the CPU
    (``device="cpu"``) the CPU counts as that many devices (default one).

    The backend is NCCL for CUDA devices and gloo for the CPU; a failure
    raises, and no other backend is tried.  torch has one timeout for the
    rendezvous and the collectives: the larger of the two given."""
    dist = _dist()
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if coordinator_address is None:
        raise ValueError("no coordinator: pass coordinator_address='host:port' or set "
                         "MASTER_ADDR and MASTER_PORT")
    world = int(num_processes if num_processes is not None else env.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None else env.get("RANK", 0))
    dev = resolve_device(device)
    if local_device_ids is None and env.get("LOCAL_RANK") is not None:
        local_device_ids = [int(env["LOCAL_RANK"])]
    if dev.type == "cpu":
        devices = [dev] * len(local_device_ids or [0])
        backend = "gloo"
    else:
        ids = (list(local_device_ids) if local_device_ids is not None
               else list(range(torch.cuda.device_count())))
        devices = [torch.device("cuda", i) for i in ids]
        torch.cuda.set_device(devices[0])
        backend = "nccl"
    timeout = datetime.timedelta(seconds=max(initialization_timeout, heartbeat_timeout_seconds))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank, timeout=timeout)
    _local_devices[:] = devices


def shutdown() -> None:
    """Leave the process group (a no-op without one)."""
    if is_initialized():
        _dist().destroy_process_group()
    _local_devices.clear()


def barrier(name: str, timeout_ms: int = 600_000) -> None:
    """Block until every process arrives here.  A no-op in one process, so
    callers need no topology guard; ``name`` documents the meeting point and
    ``timeout_ms`` bounds the wait where the backend allows it (gloo)."""
    if process_count() <= 1:
        return
    dist = _dist()
    if dist.get_backend() == "gloo":
        dist.monitored_barrier(timeout=datetime.timedelta(milliseconds=timeout_ms))
    else:
        dist.barrier()


def global_mesh(axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over every device of every process (1-D by default); every
    process drives as many devices as this one."""
    local = local_devices()
    devices = np.empty(len(local) * process_count(), dtype=object)
    devices[:] = local * process_count()
    shape = (devices.size,) + (1,) * (len(axis_names) - 1)
    return Mesh(devices.reshape(shape), tuple(axis_names), process_index=process_index(),
                process_count=process_count())


def local_shard(items: Sequence, process_index: Optional[int] = None):
    """The part of a global dataset this process is responsible for (a
    strided split, so shards stay balanced under any length)."""
    index = _rank() if process_index is None else process_index
    return list(items[index :: process_count()])


def global_batch(mesh: Mesh, local_batch: dict, axis: str = "data", put=None) -> dict:
    """This process's part of the global batch: ``local_batch`` holds its own
    rows only (the global batch is the processes' rows in process order);
    they are split over its devices, one list of pieces per key."""
    return shard_batch(mesh, {k: np.asarray(v) for k, v in local_batch.items()}, axis, put=put)
