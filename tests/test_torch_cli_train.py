"""The port CLI's ``create-dataset-file`` and ``train`` against the JAX
CLI's: the same dataset JSON, a checkpoint that both CLIs' ``predict``
load, and the multi-device and versioned-checkpoint options training."""
import json
import os
import random
import socket

import numpy as np
import pytest
import torch

from page_segmentation_tpu.cli.main import main as jax_main
from page_segmentation_tpu_torch.cli.main import main
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.core.image_io import imsave


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on the machine's cores; torch's
    # own thread pool in each then oversubscribes them, and these small
    # steps run tens of times slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """Six 48x40 pages: images, 0/255 binaries and RGB color masks."""
    root = tmp_path_factory.mktemp("cli") / "data"
    rng = np.random.default_rng(2)
    for sub in ("images", "binary_images", "masks"):
        (root / sub).mkdir(parents=True)
    for i in range(6):
        labels = np.zeros((48, 40), np.uint8)
        labels[6:18, 4:34] = 1
        labels[26:42, 8:30] = 2 if i % 2 else 1
        image = np.where(labels == 0, 230, np.where(labels == 1, 30, 120)) + rng.integers(-9, 9, (48, 40))
        imsave(str(root / "images" / f"p{i}.png"), np.clip(image, 0, 255).astype(np.uint8))
        imsave(str(root / "binary_images" / f"p{i}.png"), np.where(labels > 0, 0, 255).astype(np.uint8))
        imsave(str(root / "masks" / f"p{i}.png"), DEFAULT_IMAGE_MAP.to_rgb_array(labels))
    return root


def _dataset_file(cli, data_dir, out):
    random.seed(5)
    assert cli(["create-dataset-file", "--dataset_path", str(data_dir), "--character_height", "6",
                "--n_train", "4", "--n_test", "0.2", "--n_eval", "-1", "--output_file", str(out)]) == 0
    return out


def test_create_dataset_file_writes_the_jax_clis_json(tmp_path, data_dir):
    port = _dataset_file(main, data_dir, tmp_path / "port.json")
    ref = _dataset_file(jax_main, data_dir, tmp_path / "jax.json")
    assert port.read_bytes() == ref.read_bytes()
    split = json.loads(port.read_text())
    assert [len(split[k]) for k in ("train", "test", "eval")] == [4, 1, 1]


def test_train_checkpoint_loads_in_both_clis_predict(tmp_path, data_dir, capsys):
    split = _dataset_file(main, data_dir, tmp_path / "data.json")
    out = tmp_path / "run"
    assert main(["train", "--device", "cpu", "--split_file", str(split), "--output", str(out),
                 "--n_epoch", "2", "--l_rate", "1e-3", "--batch_size", "2",
                 "--early_stopping_max_performance_drops", "5"]) == 0
    model = out / "model"
    assert {"params.msgpack", "opt_state.msgpack", "meta.json"} <= set(os.listdir(model))
    meta = json.loads((model / "meta.json").read_text())
    assert meta["architecture"] == "fcn_skip" and meta["n_classes"] == 3
    scalars = [json.loads(line) for line in (out / "scalars.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in scalars] == [0, 1] and all("val_loss" in r for r in scalars)
    common = ["--load", str(model), "--images", str(data_dir / "images"), "--binary",
              str(data_dir / "binary_images"), "--char_height", "6"]
    assert main(["predict", "--device", "cpu", "--output", str(tmp_path / "port_pred")] + common) == 0
    assert jax_main(["predict", "--output", str(tmp_path / "jax_pred")] + common) == 0
    for side in ("port_pred", "jax_pred"):
        assert sorted(os.listdir(tmp_path / side / "color")) == [f"p{i}.png" for i in range(6)]
    capsys.readouterr()


@pytest.mark.parametrize("flag, item", [
    (["--distributed"], "item 12"),
    (["--n_devices", "2"], "item 12"),
    (["--checkpoint_backend", "orbax"], "item 11"),
    (["--auto_resume"], "item 11"),
])
def test_unported_train_options_exit_2_with_one_line(tmp_path, capsys, flag, item, data_dir,
                                                    monkeypatch):
    # ported: each option trains (2 epochs at batch 2 on the CPU);
    # --distributed joins a one-process gloo group from the launcher's
    # environment, as torchrun sets it
    from page_segmentation_tpu_torch.parallel import distributed

    split = _dataset_file(main, data_dir, tmp_path / "data.json")
    if flag == ["--distributed"]:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        for name, value in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)),
                            ("WORLD_SIZE", "1"), ("RANK", "0")):
            monkeypatch.setenv(name, value)
    out = tmp_path / "o"
    try:
        assert main(["train", "--device", "cpu", "--split_file", str(split), "--output", str(out),
                     "--n_epoch", "2", "--batch_size", "2"] + flag) == 0
        assert distributed.is_initialized() == (flag == ["--distributed"])
    finally:
        distributed.shutdown()
    capsys.readouterr()
    scalars = [json.loads(line) for line in (out / "scalars.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in scalars] == [0, 1] and np.isfinite(scalars[-1]["loss"])
    assert (out / "model" / "params.msgpack").exists()
    if flag == ["--checkpoint_backend", "orbax"]:
        assert sorted(os.listdir(out / "model_orbax")) == ["0", "1"]
    if flag == ["--auto_resume"]:  # without the orbax backend it starts fresh, as in JAX
        assert not (out / "model_orbax").exists()
