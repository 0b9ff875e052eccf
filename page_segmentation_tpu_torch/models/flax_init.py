"""flax's initial weights of every model family, drawn without JAX.

The JAX package draws a fresh model's weights with ``module.init`` from
``jax.random.PRNGKey(seed)``.  This module repeats that draw, bit for bit,
for any tree of convolution kernels:

* the key: JAX's threefry-2x32 PRNG (20 rounds, ``ops/prng.py``);
  ``PRNGKey(seed)`` is the pair (0, seed & 0xffffffff), JAX's key without
  64-bit mode;
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

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np

from ..ops.prng import fold_in_static, prng_key

GLOROT_UNIFORM = "glorot_uniform"
LECUN_NORMAL = "lecun_normal"
LAWS = (GLOROT_UNIFORM, LECUN_NORMAL)  # ps_flax_draw's ``law`` is the index

# each flax conv makes its kernel first: the scope's first make_rng("params")
KERNEL_COUNT = 1

_CHUNK = 1 << 18


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
