"""The port's checkpoint writer against the JAX package's, on the CPU.

Tolerance: none.  For the same params tree the port writes the same
``params.msgpack`` bytes as flax's ``msgpack_serialize`` (through the JAX
package's ``save_checkpoint``) and the same ``meta.json``; each package reads
the other's file to exactly equal arrays."""
import json
import os

import jax
import numpy as np
import pytest
from flax import serialization

from page_segmentation_tpu.train import checkpoint as jax_checkpoint
from page_segmentation_tpu_torch.models.bridge import init_params_numpy
from page_segmentation_tpu_torch.train import checkpoint

META = {"architecture": "fcn_skip", "n_classes": 3, "monitor": 0.25, "step": 7}


@pytest.fixture(scope="module")
def trees():
    rng = np.random.default_rng(0)
    with_biases = init_params_numpy(3, seed=0)
    for leaves in with_biases.values():
        leaves["bias"] = rng.standard_normal(leaves["bias"].shape).astype(np.float32)
    return {
        "fcn_skip_init": {"params": init_params_numpy(3, seed=0)},
        "fcn_skip_with_biases_as_jax_arrays": jax.tree_util.tree_map(jax.numpy.asarray, with_biases),
        "bare_params_with_other_dtypes": {
            "conv": {"kernel": rng.standard_normal((3, 3, 1, 4)).astype(np.float32),
                     "bias": np.arange(4, dtype=np.int64)},
            "scale": np.float32(0.5),
            "mask": rng.random((5, 7)) > 0.5,
        },
    }


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", ["fcn_skip_init", "fcn_skip_with_biases_as_jax_arrays",
                                  "bare_params_with_other_dtypes"])
def test_files_are_byte_identical_to_the_jax_packages(trees, name, tmp_path):
    tree = trees[name]
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), tree, META)
    checkpoint.save_checkpoint(str(tmp_path / "port"), tree, META)
    for file in ("params.msgpack", "meta.json"):
        assert _read(tmp_path / "port" / file) == _read(tmp_path / "jax" / file), file


@pytest.mark.parametrize("name", ["fcn_skip_with_biases_as_jax_arrays",
                                  "bare_params_with_other_dtypes"])
def test_each_package_reads_the_others_file(trees, name, tmp_path):
    checkpoint.save_checkpoint(str(tmp_path / "port"), trees[name], META)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax"), trees[name], META)
    for got, want in ((jax_checkpoint.load_checkpoint(str(tmp_path / "port")),
                       jax_checkpoint.load_checkpoint(str(tmp_path / "jax"))),
                      (checkpoint.load_checkpoint(str(tmp_path / "jax")),
                       checkpoint.load_checkpoint(str(tmp_path / "port")))):
        assert got[1] == want[1] == META
        got_leaves, got_def = jax.tree_util.tree_flatten(got[0])
        want_leaves, want_def = jax.tree_util.tree_flatten(want[0])
        assert got_def == want_def
        for g, w in zip(got_leaves, want_leaves):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_scalars_strings_and_lists_serialize_as_flax_does():
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2 ** 31 - 1],
        "floats": [0.5, -1e300, float("inf")],
        "misc": [None, True, False, "", "x" * 31, "y" * 32, "z" * 300, b"", b"b" * 300, 2 - 3j],
        "numpy": {"scalar": np.int32(-7), "zero_d": np.array(1.5), "empty": np.zeros((0, 3))},
        "map": {str(i): i for i in range(17)},
        "b": {}, "a": [],
    }
    assert checkpoint.msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    restored = checkpoint.msgpack_restore(checkpoint.msgpack_serialize(tree))
    assert restored["ints"] == tree["ints"] and restored["misc"] == tree["misc"]


def test_large_arrays_are_chunked_as_flax_chunks_them(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(checkpoint, "MAX_CHUNK_SIZE", 64)
    tree = {"w": {"kernel": np.arange(100, dtype=np.float32).reshape(4, 25),
                  "bias": np.arange(3, dtype=np.float32)},
            "listed": [np.arange(40.0)]}
    encoded = checkpoint.msgpack_serialize(tree)
    assert encoded == serialization.msgpack_serialize(tree)
    restored = checkpoint.msgpack_restore(encoded)
    np.testing.assert_array_equal(restored["w"]["kernel"], tree["w"]["kernel"])


def test_optimizer_state_is_not_ported(tmp_path):
    # ported: the msgpack optimizer state (tests/test_torch_train_optim.py)
    # and the step-versioned checkpointer (tests/test_torch_checkpoint_versioned.py),
    # whose steps hold the optimizer state beside the variables
    ckpt = checkpoint.OrbaxCheckpointer(str(tmp_path / "orbax"))
    ckpt.save(4, {"params": {"w": np.ones(2, np.float32)}}, opt_state={"count": np.int32(1)})
    step, state, _ = ckpt.restore()
    assert step == 4 and int(state["opt_state"]["count"]) == 1
    # in orbax's layout: an OCDBT store whose tree metadata names the state's leaves
    assert os.path.exists(tmp_path / "orbax" / "4" / "state" / "manifest.ocdbt")
    leaves = json.loads((tmp_path / "orbax" / "4" / "state" / "_METADATA").read_text())
    assert "('opt_state', 'count')" in leaves["tree_metadata"]
