"""UNet's training-mode step against the JAX step, in float64 as
``test_torch_families_steps.py`` holds the other families, with dropout
replaced by the identity on both sides (the port cannot draw JAX's mask);
and the port's dropout drawn from the step's generator, the same mask again
in the recomputation of ``remat``."""
import pytest
import torch
from flax import linen as nn

from page_segmentation_tpu_torch.models import unet as torch_unet
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
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


class _NoDropout(nn.Module):
    rate: float = 0.5
    deterministic: bool = True

    @nn.compact
    def __call__(self, x):
        return x


def test_unet_train_step_matches_jax(monkeypatch):
    from page_segmentation_tpu.models import unet as jax_unet

    monkeypatch.setattr(jax_unet.nn, "Dropout", _NoDropout)
    monkeypatch.setattr(torch_unet, "dropout", lambda x, rate, generator=None: x)
    (loss, grads, state), (want_loss, want_grads, _) = step_both("unet")
    assert state == {}
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert _rel(_flat(grads), _flat(dict(want_grads))) < 1e-6


def test_unet_train_step_draws_its_dropout_from_the_generator():
    arch = Architecture.UNET
    x, mask, weights = _batch(arch)
    module, _ = calibrated(arch, x)
    step, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), metrics.loss)
    batch = {"image": torch.from_numpy(x), "mask": torch.from_numpy(mask),
             "weights": torch.from_numpy(weights), "binary": torch.ones(mask.shape, dtype=torch.uint8)}
    params = dict(module.named_parameters())

    def loss(seed):
        return float(step.value_and_grad(params, {}, batch, torch.Generator().manual_seed(seed))[0])

    assert loss(1) == loss(1) != loss(2)
    remat, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), metrics.loss, remat=True)
    plain_g = step.value_and_grad(params, {}, batch, torch.Generator().manual_seed(5))[1]
    remat_g = remat.value_and_grad(params, {}, batch, torch.Generator().manual_seed(5))[1]
    for k in plain_g:  # the recomputation drew the same mask
        torch.testing.assert_close(remat_g[k], plain_g[k], rtol=1e-5, atol=1e-7)
    assert size(arch) == x.shape[1:3]
