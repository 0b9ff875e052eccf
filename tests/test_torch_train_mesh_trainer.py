"""The port's ``Trainer(n_devices=2, device="cpu")`` against the JAX
``Trainer(n_devices=2)`` on its virtual CPU devices, from one checkpoint,
and against the port's own single-device Trainer: loss and validation-loss
histories to 1e-3."""
import numpy as np
import pytest
import torch

from page_segmentation_tpu.train import trainer as jax_trainer
from page_segmentation_tpu_torch.train.trainer import Trainer
from tests.test_torch_train_trainer import _dataset, _jax_settings, _settings, jax_init  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_trainer_on_two_devices_matches_jax_and_one_device(tmp_path, jax_init):
    """4 pages at batch 3 (a ragged tail of 1: one shard all padding) and a
    validation set through the mesh eval step."""
    compared = dict(n_epoch=3, save_best_model_only=False, early_stopping_restore_best_weights=False,
                    batch_size=3, load=jax_init)
    want = jax_trainer.Trainer(_jax_settings(
        tmp_path / "jax", n_devices=2, batch_size=3, load=jax_init,
        train_data=_dataset(n_pages=4, jax_side=True),
        validation_data=_dataset(n_pages=2, seed=5, jax_side=True))).train()
    port = Trainer(_settings(tmp_path / "port", _dataset(n_pages=4), n_devices=2,
                             validation_data=_dataset(n_pages=2, seed=5), **compared))
    assert port.mesh.devices.size == 2
    got = port.train()
    single = Trainer(_settings(tmp_path / "single", _dataset(n_pages=4),
                               validation_data=_dataset(n_pages=2, seed=5), **compared)).train()
    for key in ("loss", "val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
        np.testing.assert_allclose(got[key], single[key], rtol=1e-3, err_msg=key)
