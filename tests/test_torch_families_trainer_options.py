"""The port's ``Trainer`` options that the model families bring:
``export_h5`` (a Keras ``.h5`` beside each checkpoint, which the JAX
importer reads back; also through the ``train`` CLI), ``pretrained_encoder``
(a provisioned encoder directory) and UNet's dropout, drawn per epoch from
the seed."""
import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.models import h5_import as jax_import
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.train.checkpoint import load_checkpoint
from tests.test_torch_families_trainer import _pages, _port, _start


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_export_h5_and_pretrained_encoder(tmp_path):
    """export_h5 writes <model>.h5 beside the checkpoint, read back by the
    JAX importer; pretrained_encoder loads an encoder directory."""
    arch = Architecture.MOBILE_NET
    start = _start(arch, tmp_path)
    port = _port(tmp_path, arch, n_epoch=1, export_h5=True, pretrained_encoder=start, seed=5)
    start_vars = load_checkpoint(start)[0]
    np.testing.assert_array_equal(port.params["encoder"]["stem"]["conv"]["kernel"],
                                  start_vars["params"]["encoder"]["stem"]["conv"]["kernel"])
    assert not np.array_equal(port.params["up0"]["kernel"], start_vars["params"]["up0"]["kernel"])
    port.train()
    ckpt, _ = load_checkpoint(str(tmp_path / "port" / "model"))
    exported, detected = jax_import.load_keras_variables(str(tmp_path / "port" / "model.h5"),
                                                         JaxArchitecture.MOBILE_NET, 2)
    assert detected is JaxArchitecture.MOBILE_NET
    for coll in ("params", "batch_stats"):
        for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(exported[coll]),
                                     jax.tree_util.tree_leaves_with_path(ckpt[coll])):
            if "block_16" in jax.tree_util.keystr(path) and "project" in jax.tree_util.keystr(path):
                continue  # the reference graph holds no BN there: it folds into the kernel
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))


def test_unet_dropout_is_drawn_per_epoch_from_the_seed(tmp_path, monkeypatch):
    """The same seed draws the same masks; another seed other masks (the
    weights come from the checkpoint, so only the dropout differs): each
    dropout layer draws under its own key of the seed's chain."""
    from page_segmentation_tpu_torch.models import unet

    start = _start(Architecture.UNET, tmp_path)
    keys = []
    dropout = unet.dropout
    monkeypatch.setattr(unet, "dropout", lambda x, rate, key: (
        keys.append((int(key[0]), int(key[1]))), dropout(x, rate, key))[1])
    runs = [_port(tmp_path / str(seed), Architecture.UNET, n_pages=1, n_epoch=1, load=start, seed=seed)
            for seed in (0, 0, 1)]
    a, b, c = (run.train()["loss"] for run in runs)
    assert a == b and a != c and np.isfinite(a).all()
    assert len(keys) == 3 * 2  # runs x dropout layers
    assert keys[:2] == keys[2:4] and len(set(keys)) == 4  # two layers' keys for each seed


def test_train_cli_exports_h5(tmp_path, capsys):
    from page_segmentation_tpu_torch.cli.main import main
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.core.image_io import imsave

    root = tmp_path / "data"
    for sub in ("images", "binary_images", "masks"):
        (root / sub).mkdir(parents=True)
    for i, (image, binary, mask) in enumerate(_pages(4)):
        imsave(str(root / "images" / f"p{i}.png"), image)
        imsave(str(root / "binary_images" / f"p{i}.png"), (1 - binary) * 255)
        imsave(str(root / "masks" / f"p{i}.png"), DEFAULT_IMAGE_MAP.to_rgb_array(mask))
    split = str(tmp_path / "split.json")
    assert main(["create-dataset-file", "--dataset_path", str(root), "--character_height", "6",
                 "--n_train", "1.0", "--n_test", "0", "--output_file", split]) == 0
    assert main(["train", "--device", "cpu", "--split_file", split, "--output", str(tmp_path / "out"),
                 "--n_epoch", "1", "--architecture", "res_unet", "--export_h5",
                 "--target_line_height", "6"]) == 0
    capsys.readouterr()
    exported, detected = jax_import.load_keras_variables(str(tmp_path / "out" / "model.h5"),
                                                         JaxArchitecture.FCN_SKIP, 3)
    assert detected is JaxArchitecture.RES_UNET
    ckpt, _ = load_checkpoint(str(tmp_path / "out" / "model"))
    for a, b in zip(jax.tree_util.tree_leaves(exported["params"]), jax.tree_util.tree_leaves(ckpt["params"])):
        np.testing.assert_array_equal(a, b)
