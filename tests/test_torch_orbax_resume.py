"""A training run resumed across the two packages through orbax's step
directories (``Trainer(checkpoint_backend="orbax", auto_resume=True)``), on
the CPU.

FCNSkip (2 classes) on three 40x32 pages from one JAX init.  The JAX trainer
trains 2 epochs and the port's trainer auto-resumes the third from the JAX
package's ``model_orbax/1/``; the port trains 2 epochs and the JAX trainer
auto-resumes the third from the port's step.  Each third epoch's loss and
final weights agree with the uninterrupted 3-epoch run of the package that
started it to 1e-3, the tolerance of the other cross-package trainer tests
(``tests/test_torch_train_trainer.py``): the two packages' float32 steps
round differently.  The JAX trainer's ``train()`` returns with its last save
in flight, so the test waits for it before the port looks."""
import os

import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.train import trainer as jax_trainer
from page_segmentation_tpu_torch.train.trainer import Trainer
from tests.test_torch_train_trainer import (  # noqa: F401  (jax_init is a fixture)
    COMPARED,
    _assert_params_close,
    _dataset,
    _jax_settings,
    _settings,
    jax_init,
)

ORBAX = dict(COMPARED, checkpoint_backend="orbax")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_jax_run_resumes_in_the_port(tmp_path, jax_init):
    full = jax_trainer.Trainer(_jax_settings(tmp_path / "full", load=jax_init))
    want = full.train()
    shared = str(tmp_path / "shared")
    part = jax_trainer.Trainer(_jax_settings(tmp_path, n_epoch=2, load=jax_init,
                                             output_dir=shared, checkpoint_backend="orbax"))
    part.train()
    part._orbax.wait()
    assert sorted(os.listdir(os.path.join(shared, "model_orbax"))) == ["0", "1"]
    # the JAX trainer's leaves are jax.Arrays with a device layout
    assert os.path.exists(os.path.join(shared, "model_orbax", "1", "state", "_sharding"))
    resumed = Trainer(_settings(tmp_path, _dataset(), output_dir=shared, auto_resume=True,
                                **ORBAX))
    assert resumed._resume_meta["epoch"] == 1
    tail = resumed.train()
    np.testing.assert_allclose(tail["loss"], want["loss"][2:], rtol=1e-3)
    _assert_params_close(resumed.params, jax.device_get(full.params), 1e-3)
    assert sorted(os.listdir(os.path.join(shared, "model_orbax"))) == ["0", "1", "2"]


def test_port_run_resumes_in_the_jax_package(tmp_path, jax_init):
    full = Trainer(_settings(tmp_path / "full", _dataset(), load=jax_init, **COMPARED))
    want = full.train()
    shared = str(tmp_path / "shared")
    Trainer(_settings(tmp_path, _dataset(), load=jax_init, output_dir=shared,
                      **dict(ORBAX, n_epoch=2))).train()
    assert sorted(os.listdir(os.path.join(shared, "model_orbax"))) == ["0", "1"]
    resumed = jax_trainer.Trainer(_jax_settings(tmp_path, output_dir=shared, auto_resume=True,
                                                checkpoint_backend="orbax"))
    assert resumed._resume_meta["epoch"] == 1
    tail = resumed.train()
    np.testing.assert_allclose(tail["loss"], want["loss"][2:], rtol=1e-3)
    _assert_params_close(jax.device_get(resumed.params), full.params, 1e-3)
