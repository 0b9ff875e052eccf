"""The port's ``jax.random`` (``ops/prng.py``) against JAX and flax, on the
CPU, bit for bit: the keys (``split``, ``fold_in``, flax's static fold), the
random bits, ``uniform`` for each device-augmentation range (XLA's CPU code
rounds ``floats * (maxval - minval) + minval`` once, as an FMA), ``bernoulli``
and flax ``nn.Dropout``'s forward and gradient in float32, bf16 and float64
(JAX's 64-bit mode draws its mask from 64 random bits), on odd shapes and on
more than 2**16 elements.  The CUDA kernel's own tests are in
``tests/test_torch_cuda.py``."""
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from page_segmentation_tpu_torch.models import flax_init, layers
from page_segmentation_tpu_torch.ops import prng

SHAPES = [(1, 1, 1, 1), (2, 3, 5, 7), (3, 17, 41, 33)]  # the last: 69,003 elements
# DeviceAugmentConfig's and AugmentationSettings' ranges, and the wider ones tests use
RANGES = [(-2.5, 2.5), (-0.025, 0.025), (0.0, 0.0), (0.95, 1.05), (-8.0, 8.0), (-3.0, 3.0),
          (0.0, 1.0)]


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_keys_match_jax(seed):
    key, want = prng.prng_key(seed), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(np.array(key, np.uint32), np.asarray(want))
    for n in (2, 3, 6, 7):
        np.testing.assert_array_equal(np.array(prng.split(key, n), np.uint32),
                                      np.asarray(jax.random.split(want, n)))
    for data in (0, 1, 12345, 2 ** 32 - 1):
        np.testing.assert_array_equal(np.array(prng.fold_in(key, data), np.uint32),
                                      np.asarray(jax.random.fold_in(want, data)))


def test_flax_init_draws_with_these_keys():
    """``models/flax_init.py`` keeps no copy of the key arithmetic."""
    assert flax_init.fold_in_static is prng.fold_in_static
    assert flax_init.prng_key is prng.prng_key


@pytest.mark.parametrize("shape", [(1,), (3, 5), (70_001,), (2, 3, 4, 5)])
def test_random_bits_match_jax(shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(11), shape))
    got = prng.random_bits(prng.prng_key(11), shape).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("minval, maxval", RANGES)
@pytest.mark.parametrize("n", [8, 70_001])
def test_uniform_matches_jax(minval, maxval, n):
    key = jax.random.split(jax.random.PRNGKey(3), 6)[4]
    want = np.asarray(jax.random.uniform(key, (n,), jnp.float32, minval, maxval))
    got = prng.uniform(tuple(np.asarray(key)), (n,), minval, maxval)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def _nearest_float32(exact: Fraction) -> np.float32:
    """The float32 nearest ``exact``, ties to even."""
    guess = np.float32(float(exact))
    candidates = [np.nextafter(guess, np.float32(-np.inf)), guess, np.nextafter(guess, np.float32(np.inf))]
    return min(candidates, key=lambda f: (abs(Fraction(float(f)) - exact),
                                          int(np.array(f).view(np.uint32)) & 1))


def test_fma32_rounds_once():
    """``a * b + c`` rounded once to float32, on products whose sum spans
    more bits than float64 holds."""
    rng = np.random.default_rng(0)
    a = np.float32(rng.integers(0, 2 ** 23, 400) * 2.0 ** -23)
    for b, c in [(5.0, -2.5), (2.0 ** -30, 1.0), (3.0e-9, -1.0 - 2.0 ** -23), (1.0e7, 3.0e-3)]:
        b32, c32 = np.float32(b), np.float32(c)
        got = prng.fma32(torch.from_numpy(a), b32, c32).numpy()
        want = [_nearest_float32(Fraction(float(x)) * Fraction(float(b32)) + Fraction(float(c32)))
                for x in a]
        np.testing.assert_array_equal(got.view(np.uint32), np.float32(want).view(np.uint32))


@pytest.mark.parametrize("p", [0.5, 0.1])
def test_bernoulli_matches_jax(p):
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(4), p, (70_001,)))
    np.testing.assert_array_equal(prng.bernoulli(prng.prng_key(4), p, (70_001,)).numpy(), want)


class _TwoDropouts(nn.Module):
    """Dropouts named as UNet's: ``Dropout_0``, then ``Dropout_1``."""
    rate: float

    @nn.compact
    def __call__(self, x):
        return (nn.Dropout(self.rate, deterministic=False)(x),
                nn.Dropout(self.rate, deterministic=False)(x))


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float64": (torch.float64, jnp.float64)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.5, 0.1])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dropout_matches_flax(shape, rate, dtype):
    """Forward and gradient, bit for bit, on NCHW against flax on NHWC."""
    torch_dtype, jax_dtype = DTYPES[dtype]
    rng = np.random.default_rng(1)
    n, c, h, w = shape
    x = rng.standard_normal((n, h, w, c))
    g = rng.standard_normal((n, h, w, c))
    with jax.enable_x64(dtype == "float64"):
        module = _TwoDropouts(rate)
        xj, gj = jnp.asarray(x, jax_dtype), jnp.asarray(g, jax_dtype)
        outs, vjp = jax.vjp(lambda v: module.apply({}, v, rngs={"dropout": jax.random.PRNGKey(9)}), xj)
        grads = [vjp((gj, jnp.zeros_like(gj)))[0], vjp((jnp.zeros_like(gj), gj))[0]]
    for i, (want, want_grad) in enumerate(zip(outs, grads)):
        xt = torch.tensor(x, dtype=torch_dtype).permute(0, 3, 1, 2).requires_grad_(True)
        key = prng.fold_in_static(prng.prng_key(9), (f"Dropout_{i}", 1))
        y = layers.dropout(xt, rate, key)
        (grad,) = torch.autograd.grad(y, xt, torch.tensor(g, dtype=torch_dtype).permute(0, 3, 1, 2))
        for got, ref in ((y, want), (grad, want_grad)):
            got = got.detach().permute(0, 2, 3, 1).to(torch.float64).numpy()
            np.testing.assert_array_equal(got, np.asarray(ref, np.float64))
        torch.testing.assert_close(prng.dropout_plain(xt.detach(), key, rate), y.detach(), rtol=0, atol=0)
    kept = np.asarray(outs[0]) != 0
    if kept.size > 2 ** 16:
        assert abs(kept.mean() - (1 - rate)) < 0.01


def test_the_kernel_wrappers_take_only_card_tensors():
    """On the CPU the plain version runs and no kernel launch is counted; the
    kernel's own wrapper refuses a CPU tensor."""
    before = (prng.launches, prng.uniform_launches)
    prng.dropout(torch.ones(1, 2, 3, 4), 0.5, prng.prng_key(0))
    prng.uniform(prng.prng_key(0), (3,), 0.0, 1.0, "cpu")
    assert (prng.launches, prng.uniform_launches) == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        prng._dropout_cuda(torch.ones(1, 1, 2, 2), prng.prng_key(0), 0.5)
