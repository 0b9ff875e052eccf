"""flax's initial weights of FCNSkip and FCN, drawn without JAX.

The JAX package draws a fresh model's weights with ``module.init`` from
``jax.random.PRNGKey(seed)``.  This module repeats that draw in numpy, bit
for bit, for the models whose every kernel belongs to a direct child
module, as FCNSkip's and FCN's do:

* the key: JAX's threefry-2x32 PRNG (20 rounds); ``PRNGKey(seed)`` is the
  pair (0, seed & 0xffffffff), JAX's key without 64-bit mode;
* each parameter's key: flax folds the child's name and the scope's
  parameter counter (1 for ``kernel``, the first parameter a layer makes)
  into the root key, as the first 4 bytes of the SHA-1 of their bytes,
  through ``jax.random.fold_in``;
* the values: ``glorot_uniform``, the variance ``1 / fan_avg`` rounded to
  float32 and scaled by ``sqrt(3 * variance)`` in float32, times a uniform
  draw in [-1, 1) made from the key's partitionable random bits (the flat
  index as a 64-bit counter, the two output words XORed); biases are zero.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's threefry-2x32 hash of the uint32 counter words ``(x0, x1)``."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0 = x0.astype(np.uint32) + ks[0]
        x1 = x1.astype(np.uint32) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
                x1 = x1 ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` without 64-bit mode: the seed's low 32
    bits behind a zero word."""
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def fold_in(key: Key, data: int) -> Key:
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data], np.uint32))
    return y0[0], y1[0]


def fold_in_static(key: Key, data) -> Key:
    """flax's fold of static names and counters into ``key``."""
    if not data:
        return key
    digest = hashlib.sha1()
    for x in data:
        digest.update(x.encode() if isinstance(x, str)
                      else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


def uniform(key: Key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, -1, 1)``."""
    n = int(np.prod(shape))
    index = np.arange(n, dtype=np.uint64)
    b0, b1 = threefry2x32(key, (index >> np.uint64(32)).astype(np.uint32),
                          (index & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    bits = (b0 ^ b1).reshape(shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    return np.maximum(np.float32(-1), floats * np.float32(2) + np.float32(-1))


def glorot_uniform(key: Key, shape) -> np.ndarray:
    """flax's ``glorot_uniform()`` of an HWIO-like (kh, kw, a, b) shape."""
    receptive = int(np.prod(shape[:-2]))
    variance = np.float32(1.0 / ((shape[-2] * receptive + shape[-1] * receptive) / 2))
    return uniform(key, shape) * np.sqrt(np.float32(3) * variance)


def fcn_params(named_shapes, seed: int) -> dict:
    """flax's fresh params for ``named_shapes``, (child name, leaf, JAX
    shape) of a model whose layers are direct children with a kernel and a
    bias each."""
    root = prng_key(seed)
    params: dict = {}
    for child, leaf, shape in named_shapes:
        if leaf == "kernel":
            value = glorot_uniform(fold_in_static(root, (child, 1)), shape)
        else:
            value = np.zeros(shape, np.float32)
        params.setdefault(child, {})[leaf] = value
    return params
