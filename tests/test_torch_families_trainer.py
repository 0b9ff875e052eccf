"""The port's ``Trainer`` on the model families against the JAX trainer, on
the CPU: both start from one checkpoint (seeded weights with calibrated
BatchNorm statistics, written by the port) and train 2 epochs on the same
batches; loss histories agree to 1e-3, as the FCN trainer tests hold them,
and the checkpoints carry ``batch_stats`` in flax's layout.  The BatchNorm
family trains with SGD on whole-dataset batches (one step an epoch):
behind a training-mode BatchNorm many parameters have a true gradient of
~0, whose float32 noise (another summation order in each package) Adam's
normalization turns into full-size steps, and a BatchNorm over one small
page's deepest maps (4 values a channel) makes that noise larger.
``test_torch_families_trainer_options.py`` holds ``export_h5``,
``pretrained_encoder`` and UNet's per-epoch dropout."""
import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import ColorMap as JaxColorMap
from page_segmentation_tpu.data.dataset import Dataset as JaxDataset
from page_segmentation_tpu.data.dataset import SingleData as JaxSingleData
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.models import h5_import as jax_import
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.models.registry import Optimizers as JaxOptimizers
from page_segmentation_tpu.train import trainer as jax_trainer
from page_segmentation_tpu.train.metrics import Monitor as JaxMonitor
from page_segmentation_tpu_torch.core.colors import ColorMap
from page_segmentation_tpu_torch.data.dataset import Dataset, SingleData
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from page_segmentation_tpu_torch.train.metrics import Monitor
from page_segmentation_tpu_torch.train.trainer import Trainer, TrainSettings
from tests.torch_families import calibrated

TWO_CLASSES = {"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text")}
HW = (64, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pages(n=3, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        mask = np.zeros(HW, np.uint8)
        mask[10 + i : 40, 8:50 - i] = 1
        image = np.where(mask == 1, 200, 10).astype(np.uint8)
        image = np.clip(image + rng.randint(-5, 5, image.shape), 0, 255).astype(np.uint8)
        out.append((image, (mask == 1).astype(np.uint8), mask))
    return out


def _dataset(jax_side=False, n=3):
    single, dataset, cmap = ((JaxSingleData, JaxDataset, JaxColorMap) if jax_side
                             else (SingleData, Dataset, ColorMap))
    return dataset([single(image=i, binary=b, mask=m) for i, b, m in _pages(n)], cmap(TWO_CLASSES))


COMMON = dict(n_epoch=2, n_classes=2, l_rate=1e-3, validation_data=None, display=10, threads=1,
              early_stopping_max_performance_drops=0, reduce_lr_on_plateau=False,
              save_best_model_only=False, early_stopping_restore_best_weights=False)


def _port(tmp_path, arch, n_pages=3, **kwargs):
    return Trainer(TrainSettings(train_data=_dataset(n=n_pages), output_dir=str(tmp_path / "port"),
                                 architecture=arch, monitor=Monitor.LOSS, device="cpu",
                                 **{**COMMON, **kwargs}))


def _jax(tmp_path, arch, **kwargs):
    return jax_trainer.Trainer(jax_trainer.TrainSettings(
        train_data=_dataset(jax_side=True), output_dir=str(tmp_path / "jax"),
        architecture=JaxArchitecture(arch.value), monitor=JaxMonitor.LOSS, **{**COMMON, **kwargs}))


def _start(arch, tmp_path):
    """One checkpoint both trainers load: seeded weights, BatchNorm
    statistics calibrated on the training pages."""
    fn, rgb = arch.preprocess()
    x = np.stack([np.asarray(fn(np.stack([i] * 3, -1) if rgb else i[..., None]), np.float32)
                  for i, _, _ in _pages()])
    _, variables = calibrated(arch, x)
    variables["params"]["logits"] = {k: v[..., :2] for k, v in variables["params"]["logits"].items()}
    path = str(tmp_path / "start")
    save_checkpoint(path, variables, {"architecture": arch.value, "n_classes": 2})
    return path


@pytest.mark.parametrize("name", ["res_unet", "mobile_net"])
def test_two_epochs_match_jax_with_batch_stats_in_the_checkpoint(name, tmp_path):
    arch = Architecture(name)
    start = _start(arch, tmp_path)
    sgd = {} if name == "res_unet" else dict(l_rate=0.05, batch_size=3)
    jax_run = _jax(tmp_path, arch, load=start, **sgd,
                   **({"optimizer": JaxOptimizers.SGD} if sgd else {}))
    want = jax_run.train()
    port = _port(tmp_path, arch, load=start, **sgd, **({"optimizer": Optimizers.SGD} if sgd else {}))
    got = port.train()
    assert got["loss"][1] < got["loss"][0]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)

    variables, meta = load_checkpoint(str(tmp_path / "port" / "model"))
    assert meta["architecture"] == name and meta["epoch"] == 1
    jax_variables, _ = load_checkpoint(str(tmp_path / "jax" / "model"))
    assert set(variables) == set(jax_variables) == ({"params", "batch_stats"} if name == "mobile_net"
                                                    else {"params"})
    assert jax.tree_util.tree_structure(variables) == jax.tree_util.tree_structure(jax_variables)
    if name == "mobile_net":
        got_stats = np.concatenate([a.ravel() for a in jax.tree_util.tree_leaves(variables["batch_stats"])])
        want_stats = np.concatenate([a.ravel() for a in jax.tree_util.tree_leaves(jax_variables["batch_stats"])])
        assert np.linalg.norm(got_stats - want_stats) <= 1e-4 * np.linalg.norm(want_stats)
        start_stats = load_checkpoint(start)[0]["batch_stats"]
        assert not np.array_equal(variables["batch_stats"]["encoder"]["stem"]["bn"]["var"],
                                  start_stats["encoder"]["stem"]["bn"]["var"])
    # the JAX package's classifier loads the port's checkpoint
    classifier = JaxClassifier(n_classes=2, model_path=str(tmp_path / "port" / "model"))
    assert classifier.architecture.value == name
