"""The port's device meshes (``parallel/mesh.py``) and its process plumbing
(``parallel/distributed.py``) against the JAX package's, on the CPU.

``make_mesh`` lays devices out as the JAX one does, with its error text; an
explicit device list may repeat a device, as ``jax.sharding.Mesh`` accepts;
the CPU counts as as many devices as asked for, and the default (every
card) raises without one.  ``shard_batch`` places the same rows on the
same mesh positions as the JAX package's shards.  ``psum`` sums shard by
shard; module replicas follow their module's weights; in one process
``local_shard`` keeps every item and ``barrier`` returns at once."""
import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.parallel import distributed as jax_distributed
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu.parallel.mesh import shard_batch as jax_shard_batch
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.parallel import distributed
from page_segmentation_tpu_torch.parallel.mesh import (
    Mesh,
    data_sharding,
    make_mesh,
    psum,
    replicas_of,
    replicated,
    shard_batch,
)

CPU = torch.device("cpu")


@pytest.mark.parametrize("kwargs", [
    dict(n_devices=4),
    dict(n_devices=4, shape=(2, 2), axis_names=("data", "space")),
    dict(n_devices=2, axis_names=("data", "space")),
    dict(shape=(1, 4), axis_names=("data", "space")),
])
def test_make_mesh_shapes_equal_jax(kwargs):
    mesh = make_mesh(**kwargs, devices="cpu" if "shape" in kwargs else ["cpu"] * 8)
    want = jax_make_mesh(**kwargs, devices=jax.devices()[:8] if "shape" not in kwargs else None)
    assert mesh.devices.shape == want.devices.shape and mesh.devices.size == want.devices.size
    assert mesh.axis_names == want.axis_names
    assert mesh.shape == dict(want.shape)
    assert all(d == CPU for d in mesh.devices.flat)


def test_too_many_devices_raise_the_jax_text():
    with pytest.raises(ValueError) as got:
        make_mesh(9, devices=["cpu"] * 8)
    with pytest.raises(ValueError) as want:
        jax_make_mesh(9)
    assert str(got.value) == str(want.value) == "Requested 9 devices, have 8"


def test_repeated_devices_are_accepted_as_in_jax():
    mesh = make_mesh(devices=["cpu", "cpu"])
    assert mesh.devices.size == 2 and mesh.local_devices == [CPU, CPU]
    first = jax.devices()[0]
    assert jax_make_mesh(devices=[first, first]).devices.size == 2


def test_cpu_counts_as_the_devices_asked_for_and_cuda_needs_a_card():
    assert make_mesh(3, devices="cpu").devices.size == 3
    assert make_mesh(devices="cpu").devices.size == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(2)


@pytest.mark.parametrize("shape", [(4,), (2, 2)])
def test_shard_batch_places_the_jax_shards(shape):
    names = ("data",) if len(shape) == 1 else ("data", "space")
    n = int(np.prod(shape))
    mesh = make_mesh(n, shape=shape, axis_names=names, devices="cpu")
    jax_mesh = jax_make_mesh(n, shape=shape, axis_names=names)
    batch = {"x": np.arange(8 * 3, dtype=np.float32).reshape(8, 3),
             "m": np.arange(8, dtype=np.int32)}
    got = shard_batch(mesh, batch)
    want = jax_shard_batch(jax_mesh, batch)
    for key in batch:
        by_device = {s.device: np.asarray(s.data) for s in want[key].addressable_shards}
        jax_pieces = [by_device[d] for d in jax_mesh.devices[:, 0].flat] if len(shape) == 2 else \
            [by_device[d] for d in jax_mesh.devices.flat]
        assert len(got[key]) == len(jax_pieces) == shape[0]
        for piece, jax_piece in zip(got[key], jax_pieces):
            np.testing.assert_array_equal(piece.numpy(), jax_piece)
        np.testing.assert_array_equal(np.concatenate([p.numpy() for p in got[key]]), batch[key])


def test_shardings_and_psum():
    mesh = make_mesh(4, devices="cpu")
    arr = np.arange(12).reshape(4, 3)
    assert [c.tolist() for c in data_sharding(mesh).chunks(arr)] == [[r] for r in arr.tolist()]
    assert all(c is arr for c in replicated(mesh).chunks(arr))
    with pytest.raises(ValueError, match="does not divide"):
        data_sharding(mesh).chunks(np.zeros((6, 1)))
    per_shard = [[torch.full((2, 2), float(i)), torch.tensor([i], dtype=torch.int64)]
                 for i in range(4)]
    total, count = psum(mesh, per_shard)
    np.testing.assert_array_equal(total.numpy(), np.full((2, 2), 6.0))
    assert count.dtype == torch.int64 and count.tolist() == [6]


def test_module_replicas_follow_their_module():
    module = FCNSkip(3)
    replicas = replicas_of(module)
    assert replicas is replicas_of(module) and replicas.on("cpu") is module
    meta = torch.device("meta")
    copy = replicas.on(meta)
    assert copy is not module and next(copy.parameters()).device == meta
    assert replicas.on(meta) is copy
    key = replicas._copies[meta][0]
    with torch.no_grad():
        next(module.parameters()).add_(1.0)  # an in-place update: the replica refreshes
    assert replicas.on(meta) is copy and replicas._copies[meta][0] != key


def test_one_process_plumbing_equals_jax():
    assert distributed.process_count() == jax.process_count() == 1
    items = list(range(9))
    assert distributed.local_shard(items) == jax_distributed.local_shard(items) == items
    assert distributed.local_shard(items, process_index=0) == items
    distributed.barrier("no-op")  # one process: returns at once, as in JAX
    mesh = Mesh(np.array([CPU] * 4, dtype=object), ("data",), process_index=1, process_count=2)
    assert mesh.local_devices == [CPU, CPU] and len(mesh.axis_devices("data")) == 2
    local = distributed.global_batch(mesh, {"x": np.arange(4)})
    assert [p.tolist() for p in local["x"]] == [[0, 1], [2, 3]]


def test_initialize_needs_a_coordinator(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        distributed.initialize(device="cpu")
    assert not distributed.is_initialized()
