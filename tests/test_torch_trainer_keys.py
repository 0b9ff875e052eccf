"""The port's ``Trainer`` against the JAX trainer from the same seed, with
the device draws live on both sides, on the CPU: both start from flax's
fresh weights of that seed and walk the same key chain (``fold_in(PRNGKey(
seed), epoch)``, one ``split`` a step for the dropout key and one more for
the device augmentation's key), so UNet drops the same elements.  Two
epochs; the epoch losses agree to 1e-3, as the FCN trainer tests hold them.
FCNSkip with ``device_augmentation`` is in ``test_torch_augment_keys.py``."""
import numpy as np
import pytest
import torch

from page_segmentation_tpu_torch.models.registry import Architecture
from tests.test_torch_families_trainer import _jax, _port


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_unet_two_epochs_with_dropout_match_jax(tmp_path):
    kwargs = dict(seed=4, l_rate=1e-4)
    want = _jax(tmp_path, Architecture.UNET, **kwargs).train()
    got = _port(tmp_path, Architecture.UNET, **kwargs).train()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
