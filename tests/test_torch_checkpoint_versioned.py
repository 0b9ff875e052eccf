"""The port's step-versioned asynchronous checkpoints
(``train/checkpoint.py`` ``OrbaxCheckpointer``) and ``Trainer(
checkpoint_backend="orbax", auto_resume=True)``, on the CPU.

``max_to_keep`` prunes the oldest steps; ``restore`` gives the newest step
(or the one asked for) as ``(step, state, meta)``; a save copies the state
before it returns and lands under its step's name only when complete; each
step is in orbax's layout, which the JAX package's ``OrbaxCheckpointer``
restores to equal arrays.  A run stopped after 2 epochs and auto-resumed for
the third equals the uninterrupted 3-epoch run."""
import json
import os

import numpy as np
import pytest
import torch

from page_segmentation_tpu.train.checkpoint import OrbaxCheckpointer as JaxOrbaxCheckpointer
from page_segmentation_tpu_torch.train import orbax_format
from page_segmentation_tpu_torch.train.checkpoint import OrbaxCheckpointer
from page_segmentation_tpu_torch.train.trainer import Trainer
from tests.test_torch_train_trainer import _dataset, _settings


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _variables(value):
    return {"params": {"conv": {"kernel": np.full((2, 3), value, np.float32),
                                "bias": np.arange(3, dtype=np.float32) + value}}}


def test_max_to_keep_and_restore(tmp_path):
    ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"), max_to_keep=2)
    assert ckpt.restore() is None and ckpt.latest_step() is None
    for step in range(4):
        ckpt.save(step, _variables(step), meta={"epoch": step, "lr": 0.1 * step})
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and sorted(os.listdir(tmp_path / "orbax")) == ["2", "3"]
    step, state, meta = ckpt.restore()
    assert step == 3 and meta == {"epoch": 3, "lr": 0.30000000000000004} and "opt_state" not in state
    np.testing.assert_array_equal(state["variables"]["params"]["conv"]["bias"], [3, 4, 5])
    step, state, _ = ckpt.restore(step=2)
    assert step == 2 and state["variables"]["params"]["conv"]["kernel"][0, 0] == 2
    ckpt.close()
    # a fresh checkpointer over the same directory sees the same steps
    assert OrbaxCheckpointer(str(tmp_path / "orbax")).latest_step() == 3


def test_save_copies_the_state_and_writes_atomically(tmp_path, monkeypatch):
    ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"))
    tensor = torch.ones(4)
    ckpt.save(7, {"params": {"w": tensor}}, opt_state={"count": np.int32(5), "mu": {"w": tensor}})
    tensor.add_(1.0)  # the training state moves on while the save is in flight
    _, state, _ = ckpt.restore()
    np.testing.assert_array_equal(state["variables"]["params"]["w"], np.ones(4, np.float32))
    assert int(state["opt_state"]["count"]) == 5
    assert os.listdir(tmp_path / "orbax") == ["7"]  # no temporary name left behind

    def failing(path, *args, **kwargs):
        os.makedirs(path)
        raise OSError("disk full")

    monkeypatch.setattr(orbax_format, "write_state", failing)
    ckpt.save(8, _variables(8))
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert os.listdir(tmp_path / "orbax") == ["7"]  # the failed step never took its name


def test_step_directory_reads_in_the_jax_package(tmp_path):
    ckpt = OrbaxCheckpointer(str(tmp_path / "orbax"))
    opt = {"0": {"count": np.int32(3), "mu": _variables(0.5)["params"]}, "1": {}}
    ckpt.save(1, _variables(1.5), opt_state=opt, meta={"epoch": 1})
    ckpt.wait()
    jax_ckpt = JaxOrbaxCheckpointer(str(tmp_path / "orbax"))
    step, state, meta = jax_ckpt.restore()
    jax_ckpt.close()
    assert step == 1 and meta == {"epoch": 1}
    for leaf in ("kernel", "bias"):
        got = np.asarray(state["variables"]["params"]["conv"][leaf])
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, _variables(1.5)["params"]["conv"][leaf])
    assert np.asarray(state["opt_state"]["0"]["count"]).dtype == np.int32
    assert int(state["opt_state"]["0"]["count"]) == 3 and state["opt_state"]["1"] == {}
    np.testing.assert_array_equal(np.asarray(state["opt_state"]["0"]["mu"]["conv"]["bias"]),
                                  opt["0"]["mu"]["conv"]["bias"])


def test_auto_resume_equals_the_uninterrupted_run(tmp_path):
    kwargs = dict(checkpoint_backend="orbax", save_best_model_only=False,
                  early_stopping_restore_best_weights=False, reduce_lr_on_plateau=True,
                  early_stopping_max_performance_drops=4)
    full = Trainer(_settings(tmp_path / "full", _dataset(), n_epoch=3, **kwargs))
    want = full.train()
    assert sorted(os.listdir(tmp_path / "full" / "out" / "model_orbax")) == ["0", "1", "2"]

    Trainer(_settings(tmp_path / "part", _dataset(), n_epoch=2, **kwargs)).train()
    resumed = Trainer(_settings(tmp_path / "part", _dataset(), n_epoch=3, auto_resume=True,
                                **kwargs))
    assert resumed._resume_meta["epoch"] == 1 and resumed._resume_meta["global_step"] == 6.0
    tail = resumed.train()
    np.testing.assert_allclose(tail["loss"], want["loss"][2:], rtol=1e-6)
    for k, v in full._live().items():
        np.testing.assert_allclose(resumed._live()[k].detach().numpy(), v.detach().numpy(),
                                   rtol=1e-6, atol=1e-8, err_msg=k)
    assert OrbaxCheckpointer(str(tmp_path / "part" / "out" / "model_orbax")).latest_step() == 2
    lines = (tmp_path / "part" / "out" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1, 2]


def test_auto_resume_without_versioned_steps_starts_fresh(tmp_path):
    fresh = Trainer(_settings(tmp_path, _dataset(), n_epoch=1))
    for backend in ("orbax", "msgpack"):
        trainer = Trainer(_settings(tmp_path, _dataset(), n_epoch=1, auto_resume=True,
                                    checkpoint_backend=backend))
        assert trainer._resume_meta is None and trainer._orbax is None
        for k, v in fresh._live().items():
            assert torch.equal(trainer._live()[k], v)
