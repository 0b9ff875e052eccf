"""The training data path of the port against the JAX package: dataset
directories, dataset JSON, seeded splits, ``DatasetLoader`` in training
mode, and the ``Network`` facade's data feed and evaluation (1e-5)."""
import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP as JAX_MAP
from page_segmentation_tpu.data import dataset as jax_dataset
from page_segmentation_tpu.data.loader import DatasetLoader as JaxLoader
from page_segmentation_tpu.network import Network as JaxNetwork
from page_segmentation_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.core.image_io import imsave
from page_segmentation_tpu_torch.data import dataset
from page_segmentation_tpu_torch.data.loader import DatasetLoader
from page_segmentation_tpu_torch.network import Network
from page_segmentation_tpu_torch.train.trainer import TrainSettings

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on the machine's cores; torch's
    # own thread pool in each then oversubscribes them, and these small
    # steps run tens of times slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N_PAGES = 5


def _write_dataset(root, n_pages=N_PAGES, h=56, w=44, char_heights=(12, 14, 16, 12, 14)):
    """A dataset directory: 8-bit images, 0/255 binaries, RGB color masks
    (background, text, image) and per-page normalization JSONs."""
    rng = np.random.default_rng(1)
    for sub in ("images", "binary_images", "masks", "normalizations"):
        (root / sub).mkdir(parents=True)
    for i in range(n_pages):
        labels = np.zeros((h, w), np.uint8)
        labels[8:20, 4:36] = 1
        labels[30:48, 10:30] = 2
        image = np.where(labels == 0, 230, np.where(labels == 1, 30, 120)) + rng.integers(-9, 9, (h, w))
        imsave(str(root / "images" / f"p{i}.png"), np.clip(image, 0, 255).astype(np.uint8))
        imsave(str(root / "binary_images" / f"p{i}.png"), np.where(labels > 0, 0, 255).astype(np.uint8))
        imsave(str(root / "masks" / f"p{i}.png"), DEFAULT_IMAGE_MAP.to_rgb_array(labels))
        (root / "normalizations" / f"p{i}.json").write_text(json.dumps({"char_height": char_heights[i]}))
    return root


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return _write_dataset(tmp_path_factory.mktemp("ds") / "data")


@pytest.mark.parametrize("kwargs", [dict(line_height_px=14), dict(), dict(verify_filenames=True)],
                         ids=["fixed_height", "normalizations", "verify_filenames"])
def test_list_dataset_matches_jax(data_dir, kwargs):
    assert dataset.list_dataset(str(data_dir), **kwargs) == jax_dataset.list_dataset(str(data_dir), **kwargs)


def test_list_dataset_errors_match_jax(tmp_path, data_dir):
    for fn in (dataset.list_dataset, jax_dataset.list_dataset):
        with pytest.raises(Exception, match="Dataset dir does not exist"):
            fn(str(tmp_path / "missing"))
    (tmp_path / "bad" / "images").mkdir(parents=True)
    (tmp_path / "bad" / "binary_images").mkdir()
    (tmp_path / "bad" / "masks").mkdir()
    (tmp_path / "bad" / "images" / "x.png").write_bytes(b"")
    messages = []
    for fn in (dataset.list_dataset, jax_dataset.list_dataset):
        with pytest.raises(Exception) as err:
            fn(str(tmp_path / "bad"), line_height_px=6)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "Mismatch" in messages[0]


@pytest.mark.parametrize("sizes", [(-1, 0, 0), (0.6, 0.2, 0.2), (2, 1, -1), (3, 3, 0)])
def test_single_split_and_create_splits_match_jax(data_dir, sizes):
    files = dataset.list_dataset(str(data_dir), line_height_px=14)
    outcomes = []
    for module in (dataset, jax_dataset):
        random.seed(3)
        try:
            outcomes.append(module.single_split(*sizes, files))
        except Exception as exc:  # too many files asked for: the same message
            outcomes.append(str(exc))
        random.seed(4)
        outcomes.append(list(module.create_splits(files, 2)))
    assert outcomes[:2] == outcomes[2:]


def test_read_dataset_json_and_training_loader_match_jax(tmp_path, data_dir):
    entries = dataset.list_dataset(str(data_dir))
    split = tmp_path / "data.json"
    split.write_text(json.dumps({"train": entries[:3], "test": entries[3:], "eval": []}))
    got = dataset.read_dataset_json([str(split)], "all")
    want = jax_dataset.read_dataset_json([str(split)], "all")
    assert [vars(e) for e in got] == [vars(e) for e in want]

    port = DatasetLoader(6, DEFAULT_IMAGE_MAP, num_workers=2).load_data_from_json([str(split)], "train")
    ref = JaxLoader(6, JAX_MAP, num_workers=2).load_data_from_json([str(split)], "train")
    assert len(port) == len(ref) == 3
    for a, b in zip(port.data, ref.data):
        for field in ("image", "binary", "orig_binary", "mask"):
            np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
        assert set(np.unique(a.mask)) <= {0, 1, 2}
    lazy = DatasetLoader(6, DEFAULT_IMAGE_MAP).load_data_from_json([str(split)], "test", lazy=True)
    assert all(e.image is None and e.prepared_shape for e in lazy.data)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A JAX init of FCNSkip (3 classes), written by the JAX save_checkpoint."""
    from page_segmentation_tpu.models.fcn import FCNSkip

    params = jax.jit(FCNSkip(n_classes=3).init)(jax.random.PRNGKey(1), jnp.zeros((1, 16, 16, 1)))
    path = str(tmp_path_factory.mktemp("ckpt") / "model")
    jax_save_checkpoint(path, {"params": jax.device_get(params["params"])},
                        meta={"architecture": "fcn_skip", "n_classes": 3})
    return path


def test_network_evaluate_dataset_matches_jax(tmp_path, data_dir, checkpoint):
    entries = dataset.list_dataset(str(data_dir), line_height_px=14)  # one bucket shape
    split = tmp_path / "data.json"
    split.write_text(json.dumps({"train": entries, "test": [], "eval": []}))
    port_data = DatasetLoader(6, DEFAULT_IMAGE_MAP).load_data_from_json([str(split)], "train")
    jax_data = JaxLoader(6, JAX_MAP).load_data_from_json([str(split)], "train")
    got = Network("eval", n_classes=3, model=checkpoint, device="cpu").evaluate_dataset(port_data)
    want = JaxNetwork("eval", n_classes=3, model=checkpoint).evaluate_dataset(jax_data)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_network_dataset_inputs_and_training(tmp_path, data_dir, checkpoint):
    entries = dataset.list_dataset(str(data_dir))
    split = tmp_path / "data.json"
    split.write_text(json.dumps({"train": entries, "test": [], "eval": []}))
    port_data = DatasetLoader(6, DEFAULT_IMAGE_MAP).load_data_from_json([str(split)], "train")
    jax_data = JaxLoader(6, JAX_MAP).load_data_from_json([str(split)], "train")
    port_net = Network("train", n_classes=3, model=checkpoint, device="cpu")
    jax_net = JaxNetwork("train", n_classes=3, model=checkpoint)
    feeds = (port_net.create_dataset_inputs(port_data, shuffle=True),
             jax_net.create_dataset_inputs(jax_data, shuffle=True))
    for _ in range(3):  # augmented, shuffled samples: the same draws
        (got_x, got_y), (want_x, want_y) = (next(f) for f in feeds)
        for key in ("input_1", "input_2"):
            np.testing.assert_array_equal(got_x[key], want_x[key], err_msg=key)
        np.testing.assert_array_equal(got_y["logits"], want_y["logits"])

    settings = TrainSettings(n_epoch=1, n_classes=3, l_rate=1e-3, train_data=port_data,
                             validation_data=None, display=0, output_dir=str(tmp_path / "out"),
                             threads=1, device="cpu")
    before = port_net.model.params["conv1"]["kernel"].copy()
    history = port_net.train_dataset(settings)
    assert len(history["loss"]) == 1
    assert not np.array_equal(port_net.model.params["conv1"]["kernel"], before)
