"""flax's initial weights of every model family, drawn without JAX.

The JAX package draws a fresh model's weights with ``module.init`` from
``jax.random.PRNGKey(seed)``.  This module repeats that draw, bit for bit,
for any tree of convolution kernels:

* the key: JAX's threefry-2x32 PRNG (20 rounds); ``PRNGKey(seed)`` is the
  pair (0, seed & 0xffffffff), JAX's key without 64-bit mode;
* each parameter's key: flax appends each module's name to its scope's rng
  suffix and ``make_rng("params")`` appends the scope's own parameter
  counter (1 for ``kernel``, the first parameter every conv makes); the
  whole suffix is folded into the root key once, as the first 4 bytes of
  the SHA-1 of its bytes, through ``jax.random.fold_in``.  The kernel of
  ``encoder/s0_b0/depthwise/conv`` has the key
  ``fold_in_static(root, ("encoder", "s0_b0", "depthwise", "conv", 1))``;
* the random bits: the key's partitionable bits, the flat index as a 64-bit
  counter and the two output words XORed; a float in [0, 1) from the top
  23 bits;
* ``glorot_uniform`` (the Keras-style ``TFConv`` and ``TFConvTranspose``):
  the variance ``1 / fan_avg`` rounded to float32 and the uniform [-1, 1)
  draw scaled by ``sqrt(3 * variance)`` in float32;
* ``lecun_normal`` (flax ``nn.Conv``'s default): ``jax.random.
  truncated_normal(key, -2, 2)`` times ``sqrt(1 / fan_in) / 0.8796...`` in
  float32, with ``fan_in`` one group's input channels over the receptive
  field.  The truncated normal repeats XLA's CPU code: the uniform draw
  ``floats * (b - a) + a`` rounded once (XLA fuses it into an FMA), XLA's
  float32 ``erf_inv`` polynomial (Giles) with FMA Horner steps, and XLA's
  float32 ``log1p`` inside it (a Cephes rational below sqrt(2) - 1, else
  the Cephes ``log`` of ``1 + x`` that XLA's CPU backend emits, with its
  FMA contractions), rules derived by comparison with JAX.

Keys and scales are worked out here; the values come from the host library
(``native/ps_native.cpp`` ``ps_flax_draw``, explicit ``fmaf``).  :func:`draw`
draws many kernels at once in fixed chunks of each kernel's flat index over
a thread pool (the library runs without the GIL); every value depends on
its index only, so the result is the same for any number of threads.
Biases, BatchNorm scales and statistics are constants and drawn by nobody
(``models/bridge.py``).
"""
from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]

GLOROT_UNIFORM = "glorot_uniform"
LECUN_NORMAL = "lecun_normal"
LAWS = (GLOROT_UNIFORM, LECUN_NORMAL)  # ps_flax_draw's ``law`` is the index

# each flax conv makes its kernel first: the scope's first make_rng("params")
KERNEL_COUNT = 1

_CHUNK = 1 << 18
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


def scale(law: str, shape) -> np.float32:
    """The float32 factor of a (kh, kw, in, out)-like kernel's unit draw;
    a depthwise kernel's ``in`` is one group's input channels."""
    receptive = int(np.prod(shape[:-2]))
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    if law == GLOROT_UNIFORM:
        return np.sqrt(np.float32(3) * np.float32(1.0 / ((fan_in + fan_out) / 2)))
    if law == LECUN_NORMAL:
        return np.sqrt(np.float32(1.0 / fan_in)) / np.float32(0.87962566103423978)
    raise ValueError(f"unknown initializer {law!r}; known: {LAWS}")


def draw(kernels: Sequence[Tuple[Tuple[str, ...], str, Tuple[int, ...]]], seed: int,
         threads: Optional[int] = None) -> list:
    """flax's fresh kernels from ``PRNGKey(seed)``: for each (scope path,
    law, JAX shape) the kernel that ``module.init`` gives the parameter
    ``kernel`` of that scope, drawn in chunks over ``threads`` threads
    (default: the host's cores).  The values do not depend on ``threads``."""
    from .. import native

    root = prng_key(seed)
    out, tasks = [], []
    for path, law, shape in kernels:
        n = int(np.prod(shape))
        flat = np.empty(n, np.float32)
        out.append(flat.reshape(shape))
        key = fold_in_static(root, tuple(path) + (KERNEL_COUNT,))
        code, factor = LAWS.index(law), scale(law, shape)
        tasks += [(key, code, factor, start, flat[start:start + _CHUNK])
                  for start in range(0, n, _CHUNK)]
    native.get_lib()  # built once, before the pool

    def run(task):
        native.flax_draw(*task)

    workers = max(1, threads or os.cpu_count() or 1)
    if workers == 1:
        for task in tasks:
            run(task)
    else:
        with ThreadPoolExecutor(workers) as pool:
            list(pool.map(run, tasks))
    return out
