"""A frozen training step written by the JAX package's ``OrbaxCheckpointer``,
for the port's orbax reader on the card.

``tests/orbax_fixture/`` is the checkpoint directory of one step, ``STEP``,
saved by ``page_segmentation_tpu/train/checkpoint.py`` ``OrbaxCheckpointer``
(orbax-checkpoint 0.11.32, tensorstore 0.1.80) from a tree shaped like the
JAX ``Trainer``'s state, made with numpy from a seed:

* ``variables``: ``params`` (a few conv layers, one 3 levels deep, and a
  bfloat16 leaf) and ``batch_stats`` (with a 160 KiB leaf, part tiled, part
  drawn from a few values, part random, so that zstd level 1 writes
  compressed blocks with Huffman literals and FSE sequence tables), as
  ``jax.Array`` leaves, so that orbax writes ``_sharding``;
* ``opt_state``: ``flax.serialization.to_state_dict`` of an ``optax.adam``
  state after one update (its ``count`` is an int32 scalar);
* ``meta``: the trainer's keys.

``tests/orbax_fixture/digests.json`` holds the SHA-256 of each leaf's
C-order bytes with its dtype and shape, and of the meta's sorted JSON.
``tests/test_torch_orbax_fixture.py`` regenerates the step in a temporary
directory and holds it leaf by leaf against the committed one and the
digests; ``chip_smoke.py`` ``phase_checkpoint`` reads it on the card, where
there is no JAX.  Regenerate (about 10 seconds):

    JAX_PLATFORMS=cpu python tests/make_orbax_fixture.py

``--sizes`` instead prints the bytes on disk of one FCNSkip training state
(flax's seed-0 weights and ``optax.adam``'s state after one step) saved by
each package: the JAX package's zstd level-1 frames against the port's raw
blocks.

Imports no JAX at module level: ``chip_smoke.py`` loads this file for its
constants and its port-side functions.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import sys

import numpy as np

DIRECTORY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "orbax_fixture")
DIGESTS = os.path.join(DIRECTORY, "digests.json")
STEP = 3
SEED = 13
META = {"architecture": "fcn_skip", "n_classes": 3, "monitor": "loss", "monitor_value": 0.4375,
        "epoch": STEP, "l_rate": 0.001, "lr": 0.001, "best_value": 0.4375, "wait": 0.0,
        "global_step": 12.0}
BIG = 40960  # float32 values: 160 KiB, over zstd's 128 KiB block
MAX_BYTES = 300_000


def numpy_tree():
    """(params, batch_stats, grads) as numpy; bfloat16 leaves as uint16 bits."""
    rng = np.random.default_rng(SEED)

    def f32(*shape, scale=0.1):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {
        "conv0": {"kernel": f32(3, 3, 1, 8), "bias": f32(8)},
        "block": {"conv1": {"kernel": f32(3, 3, 8, 16), "bias": f32(16)},
                  "deep": {"conv2": {"kernel": f32(1, 1, 16, 3)}}},
        "half": {"kernel": _bf16_bits(f32(4, 8))},
    }
    # a tiled quarter (long matches), a quarter drawn from 8 values (many
    # short matches: FSE tables) and a random half (Huffman literals)
    values = f32(16)
    big = np.concatenate([np.tile(values, BIG // 4 // values.size),
                          values[rng.integers(0, 8, BIG // 4)], f32(BIG // 2, scale=1.0)])
    batch_stats = {"bn0": {"mean": f32(8), "var": np.abs(f32(8)) + 1.0},
                   "bn_big": {"mean": big}}
    grads = _map(params, lambda x: f32(*x.shape) if x.dtype == np.float32
                 else _bf16_bits(f32(*x.shape)))
    return params, batch_stats, grads


def _bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bits (round to nearest even), as uint16."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def leaf_bytes(leaf):
    """(dtype name, shape, C-order bytes) of a numpy array, jax array or
    torch tensor; bfloat16 by its bits."""
    if hasattr(leaf, "detach"):  # a torch tensor
        import torch

        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", list(t.shape), t.view(torch.int16).numpy().tobytes()
        leaf = t.numpy()
    a = np.asarray(leaf)
    name = a.dtype.name
    if name == "bfloat16":
        a = a.view(np.uint16)
    return name, list(a.shape), np.ascontiguousarray(a).tobytes()


def digests(state: dict, meta: dict) -> dict:
    """The SHA-256 of every leaf of ``state`` (with dtype and shape) and of
    ``meta``; empty dicts are leaves with no digest."""
    leaves = {}
    for path, leaf in _flat(state):
        if isinstance(leaf, dict) or leaf is None:
            leaves[path] = {"empty": True}
            continue
        name, shape, data = leaf_bytes(leaf)
        leaves[path] = {"dtype": name, "shape": shape, "sha256": hashlib.sha256(data).hexdigest()}
    meta_text = json.dumps(meta, sort_keys=True).encode()
    return {"step": STEP, "leaves": leaves, "meta_sha256": hashlib.sha256(meta_text).hexdigest()}


def block_kinds(frames: bytes) -> set:
    """The kinds of zstd block in ``frames``: ``raw``, ``rle``, and for each
    compressed block ``literals:<raw|rle|huffman|treeless>`` and
    ``sequences:<predefined|rle|fse|repeat>`` per table."""
    kinds, pos = set(), 0
    while pos < len(frames):
        assert frames[pos : pos + 4] == b"\x28\xb5\x2f\xfd", "not a zstd frame"
        fhd = frames[pos + 4]
        pos += 5
        single, fcs_flag = (fhd >> 5) & 1, fhd >> 6
        pos += (0 if single else 1) + (0, 1, 2, 4)[fhd & 3]
        pos += (1 if single else 0, 2, 4, 8)[fcs_flag]
        last = False
        while not last:
            header = int.from_bytes(frames[pos : pos + 3], "little")
            pos += 3
            last, kind, size = header & 1, (header >> 1) & 3, header >> 3
            if kind == 0:
                kinds.add("raw")
            elif kind == 1:
                kinds.add("rle")
                size = 1
            else:
                block = frames[pos : pos + size]
                literals = ("raw", "rle", "huffman", "treeless")[block[0] & 3]
                kinds.add("literals:" + literals)
                lit_size = _literals_section_size(block)
                n_seq = block[lit_size]
                if n_seq:
                    head = 1 if n_seq < 128 else 2 if n_seq < 255 else 3
                    modes = block[lit_size + head]
                    for shift in (6, 4, 2):
                        kinds.add("sequences:" + ("predefined", "rle", "fse",
                                                  "repeat")[(modes >> shift) & 3])
            pos += size
        if (fhd >> 2) & 1:
            pos += 4
    return kinds


def _literals_section_size(block: bytes) -> int:
    kind, fmt = block[0] & 3, (block[0] >> 2) & 3
    if kind < 2:
        head = (1, 2, 1, 3)[fmt]
        value = int.from_bytes(block[:head], "little")
        regen = value >> 3 if head == 1 else value >> 4
        return head + (regen if kind == 0 else 1)
    head = (3, 3, 4, 5)[fmt]
    width = (10, 10, 14, 18)[fmt]
    value = int.from_bytes(block[:head], "little")
    return head + ((value >> (4 + width)) & ((1 << width) - 1))


def save(directory: str):
    """Save the fixture step with the JAX package into ``directory`` (a
    checkpoint manager's directory); returns (state as saved, meta)."""
    import jax
    import jax.numpy as jnp
    import optax
    from flax import serialization

    from page_segmentation_tpu.train.checkpoint import OrbaxCheckpointer

    params, batch_stats, grads = numpy_tree()

    def to_jax(x):
        if x.dtype == np.uint16:
            return jax.device_put(jnp.asarray(x).view(jnp.bfloat16))
        return jax.device_put(jnp.asarray(x))

    params, batch_stats, grads = (jax.tree_util.tree_map(to_jax, t)
                                  for t in (params, batch_stats, grads))
    tx = optax.adam(1e-3)
    opt_state = tx.init(params)
    _, opt_state = tx.update(grads, opt_state, params)
    variables = {"params": params, "batch_stats": batch_stats}
    ckpt = OrbaxCheckpointer(directory)
    ckpt.save(STEP, variables, opt_state=opt_state, meta=META)
    ckpt.wait()
    ckpt.close()
    state = {"variables": jax.device_get(variables),
             "opt_state": serialization.to_state_dict(jax.device_get(opt_state))}
    return state, META


def tree_size(directory: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(directory) for f in files)


def sizes() -> None:
    """Bytes on disk of FCNSkip's training state saved by each package."""
    import tempfile

    import jax
    import jax.numpy as jnp
    import optax

    from page_segmentation_tpu.models.fcn import FCNSkip
    from page_segmentation_tpu.train.checkpoint import OrbaxCheckpointer as JaxCheckpointer
    from page_segmentation_tpu_torch.train.checkpoint import OrbaxCheckpointer

    variables = jax.jit(FCNSkip(n_classes=3).init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    tx = optax.adam(1e-3)
    grads = jax.tree_util.tree_map(lambda p: jnp.sin(p * 7.0) * 1e-2, variables["params"])
    _, opt_state = jax.jit(tx.update)(grads, jax.jit(tx.init)(variables["params"]),
                                      variables["params"])
    with tempfile.TemporaryDirectory() as tmp:
        jax_ckpt = JaxCheckpointer(os.path.join(tmp, "jax"))
        jax_ckpt.save(1, variables, opt_state=opt_state, meta=META)
        jax_ckpt.wait()
        jax_ckpt.close()
        _, state, meta = OrbaxCheckpointer(os.path.join(tmp, "jax")).restore()
        port = OrbaxCheckpointer(os.path.join(tmp, "port"))
        port.save(1, state["variables"], opt_state=state["opt_state"], meta=meta)
        port.wait()
        got = {name: tree_size(os.path.join(tmp, name, "1")) for name in ("jax", "port")}
    print(f"FCNSkip training state on disk: JAX package (zstd level 1) {got['jax']} bytes, "
          f"port (raw blocks) {got['port']} bytes, ratio {got['jax'] / got['port']:.4f}")


def main() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if "--sizes" in sys.argv[1:]:
        return sizes()
    from page_segmentation_tpu_torch.train import orbax_format

    shutil.rmtree(DIRECTORY, ignore_errors=True)
    state, meta = save(DIRECTORY)
    store = orbax_format.read_ocdbt(os.path.join(DIRECTORY, str(STEP), "state"))
    kinds = block_kinds(bytes(store[b"variables.batch_stats.bn_big.mean/0"]))
    for need in ("literals:huffman", "sequences:fse"):
        assert need in kinds, f"the 160 KiB leaf's frame has no {need} block: {sorted(kinds)}"
    with open(DIGESTS, "w") as f:
        json.dump(digests(state, meta), f, indent=1, sort_keys=True)
    size = tree_size(DIRECTORY)
    assert size <= MAX_BYTES, f"{DIRECTORY} holds {size} bytes > {MAX_BYTES}"
    print(f"{DIRECTORY}: step {STEP}, {size} bytes, blocks {sorted(kinds)}")


if __name__ == "__main__":
    main()
