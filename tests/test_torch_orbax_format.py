"""orbax's step layout in the port (``train/orbax_format.py`` and
``train/checkpoint.py`` ``OrbaxCheckpointer``) against orbax 0.11 and
tensorstore themselves, on the CPU.

Tolerance: none.  A step that the JAX package's ``OrbaxCheckpointer`` saves
(FCNSkip's variables and Adam state, a bfloat16 leaf, int leaves, a scalar,
a tree deeper than 2 levels) reads in the port to the values tensorstore's
own OCDBT store gives, key by key, and to the tree orbax's
``StandardRestore`` gives, leaf by leaf with dtypes; a step that the port
writes restores in the JAX package to the same tree and meta, its
``.zarray`` texts equal orbax's, and tensorstore reads its store.  Interior
B+tree nodes (a store tensorstore writes with small nodes) read as
tensorstore reads them; corrupt manifests and nodes raise.  Both packages
see the same finished steps, ``max_to_keep`` prunes on either side, and a
step under orbax's temporary name is no step for either."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from page_segmentation_tpu.train.checkpoint import OrbaxCheckpointer as JaxOrbaxCheckpointer
from page_segmentation_tpu_torch.train import orbax_format
from page_segmentation_tpu_torch.train.checkpoint import OrbaxCheckpointer
from tests.make_orbax_fixture import leaf_bytes

ts = pytest.importorskip("tensorstore")

META = {"architecture": "fcn_skip", "n_classes": 3, "epoch": 4, "monitor_value": 0.25,
        "lr": None, "wait": 1.0}


def _flat(tree, prefix=()):
    if isinstance(tree, dict) and tree:
        for k, v in tree.items():
            yield from _flat(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)) and tree:
        for i, v in enumerate(tree):
            yield from _flat(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _assert_same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert got.keys() == want.keys()
    for path, value in want.items():
        if isinstance(value, dict) or value is None:
            assert got[path] == value, path
            continue
        assert leaf_bytes(got[path]) == leaf_bytes(value), path


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """A step saved by the JAX package: FCNSkip's variables and Adam state
    plus a bfloat16 leaf, int leaves and a deep subtree."""
    from page_segmentation_tpu.models.fcn import FCNSkip

    variables = jax.jit(FCNSkip(n_classes=3).init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    params = dict(variables["params"])
    params["extra"] = {"half": jnp.linspace(-2, 2, 24, dtype=jnp.bfloat16).reshape(4, 6),
                       "deep": {"deeper": {"w": jnp.arange(6.0).reshape(2, 3)}}}
    tx = optax.adam(1e-3)
    opt_state = jax.jit(tx.init)(params)
    grads = jax.tree_util.tree_map(lambda p: jnp.full_like(p, 0.5), params)
    _, opt_state = jax.jit(tx.update)(grads, opt_state, params)
    state = {"params": params,
             "batch_stats": {"counts": jnp.arange(5, dtype=jnp.int32),
                             "steps": np.asarray([3, 1 << 40], np.int64)}}
    directory = str(tmp_path_factory.mktemp("jax") / "model_orbax")
    ckpt = JaxOrbaxCheckpointer(directory)
    ckpt.save(4, state, opt_state=opt_state, meta=META)
    ckpt.wait()
    step, restored, meta = ckpt.restore()
    ckpt.close()
    return directory, jax.device_get(restored), meta


def _ts_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + path}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def test_store_reads_as_tensorstore_reads_it(jax_step):
    directory, _, _ = jax_step
    state = os.path.join(directory, "4", "state")
    want = _ts_items(state)
    got = orbax_format.read_ocdbt(state)
    assert len(want) > 100 and sorted(got) == sorted(want)
    for key, value in want.items():
        assert bytes(got[key]) == value, key


def test_jax_step_restores_as_orbax_restores_it(jax_step):
    directory, want, meta = jax_step
    step, got, got_meta = OrbaxCheckpointer(directory).restore()
    assert step == 4 and got_meta == meta == META
    _assert_same_tree(got, want)
    assert isinstance(got["variables"]["params"]["extra"]["half"], torch.Tensor)
    assert got["variables"]["params"]["extra"]["half"].dtype == torch.bfloat16
    assert got["variables"]["batch_stats"]["steps"].dtype == np.int64
    assert got["opt_state"]["0"]["count"].dtype == np.int32 and got["opt_state"]["1"] == {}
    # the jax.Array leaves carry a device layout, which the port ignores
    with open(os.path.join(directory, "4", "state", "_METADATA")) as f:
        kinds = {v["value_metadata"]["value_type"] for v in json.load(f)["tree_metadata"].values()}
    assert "jax.Array" in kinds and os.path.exists(os.path.join(directory, "4", "state", "_sharding"))


def test_port_step_restores_in_the_jax_package(jax_step, tmp_path):
    jax_directory, tree, meta = jax_step
    _, state, _ = OrbaxCheckpointer(jax_directory).restore()
    ckpt = OrbaxCheckpointer(str(tmp_path / "model_orbax"))
    ckpt.save(5, state["variables"], opt_state=state["opt_state"], meta=meta)
    ckpt.wait()
    jax_ckpt = JaxOrbaxCheckpointer(str(tmp_path / "model_orbax"))
    step, restored, restored_meta = jax_ckpt.restore()
    jax_ckpt.close()
    assert step == 5 and restored_meta == meta
    _assert_same_tree(jax.device_get(restored), tree)
    # the same .zarray texts as orbax's, and no device named
    ours = orbax_format.read_ocdbt(str(tmp_path / "model_orbax" / "5" / "state"))
    theirs = orbax_format.read_ocdbt(os.path.join(jax_directory, "4", "state"))
    texts = {k: bytes(v) for k, v in theirs.items() if k.endswith(b"/.zarray")}
    assert {k: bytes(v) for k, v in ours.items() if k.endswith(b"/.zarray")} == texts
    assert not os.path.exists(tmp_path / "model_orbax" / "5" / "state" / "_sharding")


def test_tensorstore_reads_the_ports_store(tmp_path):
    rng = np.random.default_rng(3)
    items = {f"k{i:03d}/{'x' * (i % 5)}": rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
             for i, n in enumerate(rng.integers(0, 3000, 200))}
    orbax_format.write_ocdbt(str(tmp_path), items)
    got = _ts_items(str(tmp_path))
    assert got == {k.encode(): v for k, v in items.items()}
    assert {k: bytes(v) for k, v in orbax_format.read_ocdbt(str(tmp_path)).items()} == got


def test_interior_nodes_read_as_tensorstore_reads_them(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(tmp_path),
                          "config": {"max_decoded_node_bytes": 600,
                                     "max_inline_value_bytes": 50}}).result()
    rng = np.random.default_rng(1)
    for _ in range(2):  # two versions: the newest holds both batches
        txn = ts.Transaction()
        for _ in range(300):
            key = f"k{rng.integers(0, 10 ** 6):07d}/{'x' * int(rng.integers(0, 20))}"
            value = rng.integers(0, 256, int(rng.integers(0, 120)), dtype=np.uint8).tobytes()
            kv.with_transaction(txn).write(key, value).result()
        txn.commit_async().result()
    want = _ts_items(str(tmp_path))
    got = orbax_format.read_ocdbt(str(tmp_path))
    assert len(want) == 600 and {k: bytes(v) for k, v in got.items()} == want


def test_corrupt_store_raises(jax_step, tmp_path):
    import shutil

    directory, _, _ = jax_step
    state = str(tmp_path / "state")
    shutil.copytree(os.path.join(directory, "4", "state"), state)
    manifest = os.path.join(state, "manifest.ocdbt")
    with open(manifest, "rb") as f:
        good = f.read()
    for bad, message in ((good[:-1], "length"), (good[:20], "length"),
                         (good[:30] + bytes([good[30] ^ 4]) + good[31:], "CRC-32C")):
        with open(manifest, "wb") as f:
            f.write(bad)
        with pytest.raises(ValueError, match=message):
            orbax_format.read_ocdbt(state)
    with open(manifest, "wb") as f:
        f.write(good)
    node = os.path.join(state, "d", os.listdir(os.path.join(state, "d"))[0])
    with open(node, "r+b") as f:
        data = bytearray(f.read())
        data[40] ^= 1
        f.seek(0)
        f.write(data)
    with pytest.raises(ValueError, match="CRC-32C"):
        orbax_format.read_ocdbt(state)


def test_steps_max_to_keep_and_temporary_names_on_both_sides(tmp_path):
    directory = str(tmp_path / "model_orbax")
    tree = {"params": {"w": np.arange(4, dtype=np.float32)}}
    port = OrbaxCheckpointer(directory, max_to_keep=2)
    for step in (0, 1):
        port.save(step, tree, meta={"epoch": step})
    port.wait()
    jax_ckpt = JaxOrbaxCheckpointer(directory, max_to_keep=2)
    assert list(jax_ckpt.manager.all_steps()) == [0, 1]
    jax_ckpt.save(2, tree, meta={"epoch": 2})  # orbax prunes the port's oldest step
    jax_ckpt.wait()
    jax_ckpt.close()
    assert port.all_steps() == [1, 2]
    port.save(3, tree, meta={"epoch": 3})  # the port prunes orbax's
    port.wait()
    # a step being written carries orbax's temporary name: no step for either
    os.makedirs(os.path.join(directory, "4" + orbax_format.TMP_SUFFIX, "state"))
    assert port.all_steps() == [2, 3] and port.latest_step() == 3
    fresh = JaxOrbaxCheckpointer(directory, max_to_keep=2)
    assert list(fresh.manager.all_steps()) == [2, 3]
    assert fresh.restore()[2] == {"epoch": 3}
    fresh.close()


@pytest.mark.parametrize("dtype, fill", [("<f4", 1.5), ("<i8", None), ("bfloat16", "NaN")])
def test_chunked_arrays_read_as_tensorstore_reads_them(tmp_path, dtype, fill):
    # orbax writes one chunk an array; zarr v2 allows a grid of them, edge
    # chunks padded and missing chunks read as the fill value
    spec = {"driver": "zarr", "path": "grid/",
            "kvstore": {"driver": "ocdbt", "base": "file://" + str(tmp_path)},
            "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": dtype, "fill_value": fill,
                         "compressor": {"id": "zstd", "level": 3}}}
    array = ts.open(spec, create=True).result()
    values = np.arange(40, dtype=np.float32).reshape(4, 10) - 17.25
    array[:4, :].write(values.astype(array.dtype.numpy_dtype)).result()  # rows 4-6 stay unwritten
    want = array.read().result()
    store = orbax_format.read_ocdbt(str(tmp_path))
    got = orbax_format.decode_zarr(store[b"grid/.zarray"],
                                   lambda key: store.get(f"grid/{key}".encode()))
    assert len([k for k in store if not k.endswith(b".zarray")]) == 6  # of a 3 x 3 grid
    if dtype == "bfloat16":
        assert got.dtype == torch.bfloat16
        got, want = got.view(torch.int16).numpy(), np.asarray(want).view(np.int16)
    assert got.dtype == want.dtype and got.tobytes() == np.asarray(want).tobytes()
