"""UNet's training-mode step against the JAX step, in float64 as
``test_torch_families_steps.py`` holds the other families: with dropout
live on both sides under the same key (the port draws flax's masks,
``ops/prng.py``), and without dropout on both sides (no key for the port,
the JAX module's eval mode, which for UNet only turns its dropouts off);
and the port's dropout as a function of its key, the same mask again in
the recomputation of ``remat``."""
import pytest
import torch

from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.ops.prng import prng_key
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns
from tests.test_torch_families_steps import _batch, _flat, _rel, step_both
from tests.torch_families import calibrated, size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("dropout_seed", [3, None], ids=["dropout", "no_dropout"])
def test_unet_train_step_matches_jax(dropout_seed):
    """With a key both packages drop the same elements; without one neither
    drops any."""
    (loss, grads, state), (want_loss, want_grads, _) = step_both(
        "unet", dropout_seed=dropout_seed, jax_train=dropout_seed is not None)
    assert state == {}
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert _rel(_flat(grads), _flat(dict(want_grads))) < 1e-6


def test_unet_train_step_draws_its_dropout_from_the_generator():
    """The dropout key sets the masks: the same key gives the same loss,
    another key another loss, and ``remat``'s recomputation draws the same
    masks (equal gradients)."""
    arch = Architecture.UNET
    x, mask, weights = _batch(arch)
    module, _ = calibrated(arch, x)
    step, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), metrics.loss)
    batch = {"image": torch.from_numpy(x), "mask": torch.from_numpy(mask),
             "weights": torch.from_numpy(weights), "binary": torch.ones(mask.shape, dtype=torch.uint8)}
    params = dict(module.named_parameters())

    def loss(seed):
        return float(step.value_and_grad(params, {}, batch, prng_key(seed))[0])

    assert loss(1) == loss(1) != loss(2)
    remat, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), metrics.loss, remat=True)
    plain_g = step.value_and_grad(params, {}, batch, prng_key(5))[1]
    remat_g = remat.value_and_grad(params, {}, batch, prng_key(5))[1]
    for k in plain_g:  # the recomputation drew the same mask
        torch.testing.assert_close(remat_g[k], plain_g[k], rtol=1e-5, atol=1e-7)
    assert size(arch) == x.shape[1:3]
