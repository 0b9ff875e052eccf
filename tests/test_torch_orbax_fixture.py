"""The frozen JAX-written step ``tests/orbax_fixture/`` (made by
``tests/make_orbax_fixture.py``), on the CPU.

Tolerance: none.  The port reads the committed step to the SHA-256 of
``digests.json``, leaf by leaf and the meta; the JAX package, saving the
same tree again here, writes a step that the port reads to the same digests
(so the committed step is what today's JAX package writes) and whose 160 KiB
leaf is zstd blocks with Huffman literals and FSE sequence tables; the
committed step survives the port's save and restore, and the JAX package
restores the port's copy to the same digests."""
import json

import jax
import pytest

from page_segmentation_tpu.train.checkpoint import OrbaxCheckpointer as JaxOrbaxCheckpointer
from page_segmentation_tpu_torch.train import orbax_format
from page_segmentation_tpu_torch.train.checkpoint import OrbaxCheckpointer
from tests import make_orbax_fixture as fixture


@pytest.fixture(scope="module")
def committed():
    with open(fixture.DIGESTS) as f:
        return json.load(f)


def test_committed_step_matches_its_digests(committed):
    step, state, meta = OrbaxCheckpointer(fixture.DIRECTORY).restore()
    assert step == fixture.STEP and meta == fixture.META
    assert fixture.digests(state, meta) == committed
    assert fixture.tree_size(fixture.DIRECTORY) <= fixture.MAX_BYTES


def test_regenerated_step_equals_the_committed_one(committed, tmp_path):
    saved, meta = fixture.save(str(tmp_path))
    assert fixture.digests(saved, meta) == committed
    step, state, got_meta = OrbaxCheckpointer(str(tmp_path)).restore()
    assert step == fixture.STEP and fixture.digests(state, got_meta) == committed
    store = orbax_format.read_ocdbt(str(tmp_path / str(fixture.STEP) / "state"))
    kinds = fixture.block_kinds(bytes(store[b"variables.batch_stats.bn_big.mean/0"]))
    assert {"literals:huffman", "sequences:fse"} <= kinds


def test_committed_step_survives_the_ports_save_and_restore(committed, tmp_path):
    _, state, meta = OrbaxCheckpointer(fixture.DIRECTORY).restore()
    port = OrbaxCheckpointer(str(tmp_path))
    port.save(fixture.STEP, state["variables"], opt_state=state["opt_state"], meta=meta)
    step, again, again_meta = port.restore()
    assert step == fixture.STEP and fixture.digests(again, again_meta) == committed
    jax_ckpt = JaxOrbaxCheckpointer(str(tmp_path))
    _, restored, restored_meta = jax_ckpt.restore()
    jax_ckpt.close()
    assert fixture.digests(jax.device_get(restored), restored_meta) == committed
