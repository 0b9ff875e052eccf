"""``jax.random``'s own draws without JAX: keys, the draws the JAX package
makes on its device, and the CUDA kernel that makes them on the card.

Counterpart of ``jax.random`` (threefry-2x32, 20 rounds, with
``jax_threefry_partitionable``, JAX's default) and of flax ``nn.Dropout``;
the JAX package draws these in XLA outside any Pallas kernel.  Port-only,
like ``_kernels.py``.

Keys stay on the host as pairs of numpy ``uint32``:

* ``prng_key(seed)`` is ``jax.random.PRNGKey(seed)`` without 64-bit mode,
  the pair (0, seed & 0xffffffff);
* ``fold_in(key, d)`` hashes the counter (0, d); ``split(key, n)[i]`` is the
  hash of the counter (0, i), both words kept;
* ``fold_in_static(key, names)`` is flax's fold of a scope path and counter:
  the first 4 bytes of the SHA-1 of the names' bytes, through ``fold_in``.
  flax's ``make_rng("dropout")`` in the module ``Dropout_0`` is
  ``fold_in_static(key, ("Dropout_0", 1))``.

The draws hash each element's flat index as a 64-bit counter (high word,
low word):

* :func:`random_bits`: the two output words XORed, 32 bits;
* a float in [0, 1) from the top 23 bits, ``((bits >> 9) | 0x3F800000) - 1``
  as float32 (float64, JAX's 64-bit mode: the 64 bits ``w0 << 32 | w1``,
  their top 52);
* :func:`uniform`: ``floats * (maxval - minval) + minval`` rounded once
  (XLA's CPU code contracts it into an FMA), then ``max(minval, .)``;
* :func:`bernoulli`: ``uniform < p``;
* :func:`dropout_plain`: flax's ``select(bernoulli(key, keep_prob),
  x / keep_prob, 0)``, the mask drawn over the NHWC index of the NCHW
  tensor, the division in ``x``'s type (bf16: rounded from float32).

Two implementations of the draws on tensors:

* the hand-written CUDA kernels ``csrc/jax_random.cu`` (``dropout``: one
  pass reads x and writes y, serving the forward on x and the backward on
  dy; ``uniform``), launched for tensors on the card and counted in
  :data:`launches` and :data:`uniform_launches`;
* the plain PyTorch versions (``random_bits``, ``uniform_plain``,
  ``dropout_plain``), int64 ops on any device, which tensors on the CPU take.

:func:`dropout` is a ``torch.autograd.Function`` that keeps the key and the
rate, not a mask, and draws the mask again in the backward, so a
recomputation (``remat``) draws the same mask.  A CUDA tensor launches the
kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import threading
from typing import List, Tuple

import numpy as np
import torch

from .._kernels import Entry, launch
from ..train.profiling import count, span

Key = Tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

# kernel launches of csrc/jax_random.cu made by this process
launches = 0          # dropout
uniform_launches = 0  # uniform
_launch_lock = threading.Lock()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
_DROPOUT = Entry("jax_random", "ps_jax_dropout",
                 (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.c_int, ctypes.c_int, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float,
                  ctypes.c_double, ctypes.c_float))
_UNIFORM = Entry("jax_random", "ps_jax_uniform",
                 (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32,
                  ctypes.c_float, ctypes.c_float))


# ---------------------------------------------------------------- the keys
def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """JAX's threefry-2x32 hash of the uint32 counter words ``(x0, x1)``."""
    ks = (np.uint32(key[0]), np.uint32(key[1]),
          np.uint32(key[0]) ^ np.uint32(key[1]) ^ np.uint32(_PARITY))
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
    return np.uint32(0), np.uint32(seed & _M32)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.array([data & _M32], np.uint32))
    return y0[0], y1[0]


def split(key: Key, n: int = 2) -> List[Key]:
    """``jax.random.split(key, n)`` as a list of keys."""
    y0, y1 = threefry2x32(key, np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32))
    return list(zip(y0, y1))


def fold_in_static(key: Key, data) -> Key:
    """flax's fold of static names and counters into ``key``."""
    if not data:
        return key
    digest = hashlib.sha1()
    for x in data:
        digest.update(x.encode() if isinstance(x, str)
                      else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(key, int.from_bytes(digest.digest()[:4], "big"))


# ----------------------------------------------------- the plain versions
def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def _threefry_words(key: Key, n: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both threefry output words of the 64-bit counters 0..n-1, as int64
    tensors holding uint32 values."""
    k0, k1 = int(key[0]), int(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    index = torch.arange(n, dtype=torch.int64, device=device)
    x0 = ((index >> 32) + ks[0]) & _M32
    x1 = ((index & _M32) + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(key: Key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (uint32) as an int64 tensor."""
    x0, x1 = _threefry_words(key, int(np.prod(shape, dtype=np.int64)), device)
    return (x0 ^ x1).reshape(tuple(shape))


def unit_floats(key: Key, shape, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """JAX's float in [0, 1) of each element: float32 from the top 23 of the
    32 bits, float64 (JAX's 64-bit mode) from the top 52 of the 64."""
    if dtype == torch.float64:
        x0, x1 = _threefry_words(key, int(np.prod(shape, dtype=np.int64)), device)
        mantissa = (x0 << 20) | (x1 >> 12)
        return ((mantissa | 0x3FF0000000000000).view(torch.float64) - 1.0).reshape(tuple(shape))
    if dtype != torch.float32:
        raise ValueError(f"unit_floats draws float32 or float64, not {dtype}")
    bits = random_bits(key, shape, device)
    return ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def fma32(a: torch.Tensor, b: float, c: float) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as ``fmaf``: the exact product in
    float64, the sum's rounding error by TwoSum, the float64 sum rounded to
    odd, then to float32 (53 bits >= 24 + 2, so no double rounding)."""
    p = a.to(torch.float64) * float(np.float32(b))
    c = float(np.float32(c))
    s = p + c
    bp = s - c
    err = (p - bp) + (c - (s - bp))
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, np.inf), torch.full_like(s, -np.inf))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def _range(minval: float, maxval: float) -> Tuple[np.float32, np.float32]:
    """(minval, maxval - minval), each rounded to float32 as JAX does."""
    lo = np.float32(minval)
    return lo, np.float32(np.float32(maxval) - lo)


def uniform_plain(key: Key, shape, minval: float = 0.0, maxval: float = 1.0,
                  device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo, width = _range(minval, maxval)
    out = fma32(unit_floats(key, shape, torch.float32, device), width, lo)
    return torch.clamp_min(out, float(lo))


def bernoulli(key: Key, p: float, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: float32 ``uniform < p``
    (``p`` rounded to float32, so comparing with it as a Python float is the
    float32 comparison)."""
    return uniform(key, shape, 0.0, 1.0, device) < float(np.float32(p))


def dropout_plain(x: torch.Tensor, key: Key, rate: float) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` on the NCHW ``x`` with the dropout key
    ``key``: the mask over the NHWC index, the kept elements divided by
    ``1 - rate`` in ``x``'s type."""
    keep_prob = 1.0 - rate
    n, c, h, w = x.shape
    mask_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
    threshold = keep_prob if mask_dtype == torch.float64 else float(np.float32(keep_prob))
    keep = unit_floats(key, (n, h, w, c), mask_dtype, x.device).permute(0, 3, 1, 2) < threshold
    # a true division: torch multiplies by the reciprocal of a Python scalar divisor
    scaled = x / torch.tensor(keep_prob, dtype=x.dtype, device=x.device)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


# ----------------------------------------------------------------- the kernels
def _dropout_cuda(x: torch.Tensor, key: Key, rate: float) -> torch.Tensor:
    """:func:`dropout_plain` by the kernel, on the current stream."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"_dropout_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the dropout kernel takes {list(_DTYPE_CODES)}, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"the dropout kernel takes an NCHW tensor, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    if n * c >= 2 ** 31:
        raise ValueError(f"the dropout kernel takes fewer than 2**31 planes, got {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel():
        keep_prob = 1.0 - rate
        divisor = float(torch.tensor(keep_prob, dtype=x.dtype)) if x.dtype != torch.float64 else keep_prob
        launch(_DROPOUT, x.get_device(), x.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
               n, c, h, w, int(key[0]), int(key[1]), float(np.float32(keep_prob)), keep_prob, divisor)
        with _launch_lock:
            launches += 1
    return out


def _uniform_cuda(key: Key, n: int, minval: float, maxval: float, device) -> torch.Tensor:
    """:func:`uniform_plain` of ``n`` values by the kernel, on the card."""
    global uniform_launches
    out = torch.empty(n, dtype=torch.float32, device=device)
    if n:
        lo, width = _range(minval, maxval)
        launch(_UNIFORM, out.get_device(), out.data_ptr(), n, int(key[0]), int(key[1]),
               float(lo), float(width))
        with _launch_lock:
            uniform_launches += 1
    return out


def uniform(key: Key, shape, minval: float = 0.0, maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform`` (float32) on ``device``: the kernel on the
    card, the plain version on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return _uniform_cuda(key, int(np.prod(shape, dtype=np.int64)), minval, maxval,
                             device).reshape(tuple(shape))
    return uniform_plain(key, shape, minval, maxval, device)


def _dropout_any(x: torch.Tensor, key: Key, rate: float) -> torch.Tensor:
    # one pass reads x and writes y, of x's size each: the forward's and the backward's
    count("ps.dropout_bytes", 2 * x.numel() * x.element_size())
    return _dropout_cuda(x, key, rate) if x.is_cuda else dropout_plain(x, key, rate)


class JaxDropout(torch.autograd.Function):
    """flax's dropout with its gradient: the backward sends ``dy`` through
    the same mask, drawn again from the saved key."""

    @staticmethod
    def forward(ctx, x, key, rate):
        ctx.key, ctx.rate = key, rate
        return _dropout_any(x, key, rate)

    @staticmethod
    def backward(ctx, dy):
        return _dropout_any(dy, ctx.key, ctx.rate), None, None


def dropout(x: torch.Tensor, rate: float, key: Key) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` on the NCHW ``x`` under the dropout key
    ``key`` (differentiable): the kernel on the card, the plain version on
    the CPU.  With the span recorder on, the forward runs under
    ``ps.dropout`` and each pass, forward or backward, adds the bytes it
    reads and writes to ``ps.dropout_bytes``."""
    with span("ps.dropout"):
        return JaxDropout.apply(x, (np.uint32(key[0]), np.uint32(key[1])), float(rate))
