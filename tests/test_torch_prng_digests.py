"""``tests/jax_random_digests.json``, the JAX draws that ``chip_smoke.py``
holds the card's kernel against, on the CPU: regenerated from JAX and flax
here, equal to the file; and the port's plain draws (``ops/prng.py``) on the
file's keys and shapes, UNet's dropouts at the card's train batch among
them, give the file's digests, and the port's float32 UNet step with
dropout its loss."""
import pytest
import torch

from page_segmentation_tpu_torch.ops import prng
from tests import make_jax_random_digests as frozen


@pytest.fixture(scope="module")
def digests():
    return frozen.load()


def test_frozen_file_holds_the_jax_draws(digests):
    fresh = frozen.jax_digests()
    step, want_step = fresh.pop("unet_step"), digests["unet_step"]
    assert fresh == {k: v for k, v in digests.items() if k != "unet_step"}
    for key in want_step:
        assert step[key] == pytest.approx(want_step[key], rel=1e-6), key


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_port_masks_hold_the_digests(digests, dtype):
    assert frozen.port_masks(lambda x, key, rate: prng.dropout(x, rate, key), dtype, "cpu") \
        == digests["masks"]


def test_port_uniform_and_bernoulli_hold_the_digests(digests):
    uniform, flips = frozen.port_uniforms(prng.uniform, prng.bernoulli, "cpu")
    assert uniform == digests["uniform"] and flips == digests["bernoulli"]


def test_port_unet_step_loss_holds_the_jax_loss(digests):
    """Dropout moves this loss by 6e-4 relative; the two packages agree to
    float32's summation order."""
    want = digests["unet_step"]
    assert abs(want["loss"] - want["loss_without_dropout"]) > 1e-4 * want["loss"]
    assert frozen.port_unet_loss("cpu") == pytest.approx(want["loss"], rel=1e-5)
    assert frozen.port_unet_loss("cpu", dropout=False) == pytest.approx(want["loss_without_dropout"],
                                                                         rel=1e-5)
