"""The port's ``Trainer`` (``train/trainer.py``) on tiny pages, on the CPU:
the behaviour ``tests/test_train.py`` pins for the JAX trainer, then runs
against the JAX trainer from one checkpoint (a JAX init written by the JAX
``save_checkpoint``): 3-epoch loss histories to 1e-3 with and without host
augmentation (the augmented batches bit-identical), and a JAX run resumed
by the port.  Device augmentation's warp against the JAX ``_warp``."""
import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import ColorMap as JaxColorMap
from page_segmentation_tpu.data import augment_device as jax_augment_device
from page_segmentation_tpu.data.dataset import Dataset as JaxDataset
from page_segmentation_tpu.data.dataset import SingleData as JaxSingleData
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.train import trainer as jax_trainer
from page_segmentation_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from page_segmentation_tpu.train.metrics import Monitor as JaxMonitor
from page_segmentation_tpu_torch.core.colors import ColorMap
from page_segmentation_tpu_torch.data import augment_device
from page_segmentation_tpu_torch.data.dataset import Dataset, SingleData
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models.registry import Optimizers
from page_segmentation_tpu_torch.ops.prng import prng_key
from page_segmentation_tpu_torch.train.callbacks import TrainProgressCallback
from page_segmentation_tpu_torch.train.metrics import Monitor
from page_segmentation_tpu_torch.train.trainer import (
    AugmentationSettings,
    Trainer,
    TrainSettings,
    _weighted_means,
)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on the machine's cores; torch's
    # own thread pool in each then oversubscribes them, and these small
    # steps run tens of times slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TWO_CLASSES = {"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text")}


def _pages(n_pages=3, h=40, w=32, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_pages):
        mask = np.zeros((h, w), np.uint8)
        mask[10:30, 5:25] = 1
        image = np.where(mask == 1, 200, 10).astype(np.uint8)
        image = np.clip(image + rng.randint(-5, 5, image.shape), 0, 255).astype(np.uint8)
        out.append((image, (mask == 1).astype(np.uint8), mask))
    return out


def _dataset(n_pages=3, h=40, w=32, seed=0, jax_side=False):
    single, dataset, cmap = ((JaxSingleData, JaxDataset, JaxColorMap) if jax_side
                             else (SingleData, Dataset, ColorMap))
    return dataset([single(image=i, binary=b, mask=m) for i, b, m in _pages(n_pages, h, w, seed)],
                   cmap(TWO_CLASSES))


def _settings(tmp_path, train_data, **kwargs):
    defaults = dict(n_epoch=3, n_classes=2, l_rate=1e-3, train_data=train_data,
                    validation_data=None, display=10, output_dir=str(tmp_path / "out"), threads=1,
                    monitor=Monitor.LOSS, early_stopping_max_performance_drops=0,
                    reduce_lr_on_plateau=False, device="cpu")
    defaults.update(kwargs)
    return TrainSettings(**defaults)


# ------------------------------------------------ the JAX test_train patterns
def test_train_loss_decreases_and_writes_checkpoint_and_scalars(tmp_path):
    trainer = Trainer(_settings(tmp_path, _dataset(), n_epoch=4))
    history = trainer.train()
    assert len(history["loss"]) == 4 and history["loss"][-1] < history["loss"][0]
    ckpt = tmp_path / "out" / "model"
    for name in ("params.msgpack", "opt_state.msgpack", "meta.json"):
        assert (ckpt / name).exists(), name
    lines = (tmp_path / "out" / "scalars.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1, 2, 3]
    assert [t["pages"] for t in trainer.timings] == [3, 3, 3, 3]
    net = PixelClassifier(n_classes=2, model_path=str(ckpt), device="cpu")
    _, _, pred = net.predict_single_data(_dataset().data[0])
    assert pred.shape == (40, 32)


def test_train_with_validation_early_stopping_and_diagnostics(tmp_path):
    settings = _settings(tmp_path, _dataset(), validation_data=_dataset(2, seed=1), n_epoch=4,
                         monitor=Monitor.VAL_LOSS, early_stopping_max_performance_drops=2,
                         tensorboard=True)
    history = Trainer(settings).train()
    assert len(history["val_loss"]) == len(history["loss"])
    assert (tmp_path / "out" / "diagnostics" / "0-0-prediction.png").exists()


@pytest.mark.parametrize("kwargs", [
    dict(data_augmentation=True, data_augmentation_settings=AugmentationSettings()),
    dict(data_augmentation=True, device_augmentation=True),
    dict(foreground_masks=True),
    dict(batch_size=2),
    dict(compact_transfer=False),
], ids=["host_augmentation", "device_augmentation", "foreground_masks", "batch_2", "float_layout"])
def test_train_options_run(tmp_path, kwargs):
    history = Trainer(_settings(tmp_path, _dataset(4), n_epoch=2, **kwargs)).train()
    assert len(history["loss"]) == 2 and np.isfinite(history["loss"]).all()


def test_compact_transfer_matches_float_layout(tmp_path):
    data = _dataset()
    h_compact = Trainer(_settings(tmp_path / "a", data, n_epoch=2, compact_transfer=True)).train()
    h_float = Trainer(_settings(tmp_path / "b", data, n_epoch=2, compact_transfer=False)).train()
    np.testing.assert_allclose(h_compact["loss"], h_float["loss"], rtol=1e-5)


def test_train_mixed_page_sizes(tmp_path):
    rng = np.random.RandomState(0)
    pages = []
    for h, w in [(40, 32), (40, 32), (72, 48), (72, 48), (56, 64)]:
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4 : -h // 4, w // 4 : -w // 4] = 1
        image = np.where(mask == 1, 200, 10).astype(np.uint8)
        image = np.clip(image + rng.randint(-5, 5, image.shape), 0, 255).astype(np.uint8)
        pages.append(SingleData(image=image, binary=(mask == 1).astype(np.uint8), mask=mask))
    data = Dataset(pages, ColorMap(TWO_CLASSES))
    history = Trainer(_settings(tmp_path, data, batch_size=2, validation_data=data)).train()
    assert history["loss"][-1] < history["loss"][0]
    assert np.isfinite(history["val_loss"][-1])


def test_compute_baseline_and_empty_data(tmp_path):
    trainer = Trainer(_settings(tmp_path, _dataset(), n_epoch=1, compute_baseline=True))
    assert 0.5 < trainer.baseline < 1.0
    with pytest.raises(Exception, match="No training files"):
        Trainer(_settings(tmp_path, Dataset([], ColorMap(TWO_CLASSES)), n_epoch=1))


def test_progress_callback(tmp_path):
    calls = {"init": 0, "loss": 0, "best": 0}

    class CB(TrainProgressCallback):
        def init(self, total, early):
            calls["init"] += 1

        def update_loss(self, batch, loss, acc):
            calls["loss"] += 1

        def next_best(self, epoch, acc, n_best):
            calls["best"] += 1

    Trainer(_settings(tmp_path, _dataset(), n_epoch=2)).train(callback=CB())
    assert calls["init"] == 1 and calls["loss"] == 6 and calls["best"] >= 1


def test_weighted_means_page_count():
    out = _weighted_means([(4, {"loss": torch.tensor(1.0)}), (1, {"loss": 6.0})])
    assert out["loss"] == pytest.approx((4 * 1.0 + 1 * 6.0) / 5)


def test_grad_accum_matches_large_batch(tmp_path):
    data = _dataset(4)
    common = dict(n_epoch=3, optimizer=Optimizers.SGD, early_stopping_restore_best_weights=False)
    big = Trainer(_settings(tmp_path / "big", data, batch_size=4, **common))
    big.train()
    accum = Trainer(_settings(tmp_path / "acc", data, batch_size=1, grad_accum=4, **common))
    accum.train()
    for layer, leaves in big.params.items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(accum.params[layer][leaf], value, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{layer}/{leaf}")
    accum._set_lr(3e-4)
    assert accum._current_lr() == pytest.approx(3e-4)
    assert float(accum.opt_state["inner"]["learning_rate"]) == pytest.approx(3e-4)


def test_skip_nonfinite_clean_run_and_abort(tmp_path):
    history = Trainer(_settings(tmp_path / "a", _dataset(), n_epoch=2, skip_nonfinite=3)).train()
    assert history["loss"][-1] <= history["loss"][0]
    trainer = Trainer(_settings(tmp_path / "b", _dataset(), n_epoch=2, skip_nonfinite=2))
    real_step = trainer._train_step

    def poisoned(params, model_state, opt_state, batch, rng):
        p, ms, os_, metrics = real_step(params, model_state, opt_state, batch, rng)
        return p, ms, os_, {**metrics, "nonfinite": torch.tensor(1.0)}

    trainer._train_step = poisoned
    with pytest.raises(RuntimeError, match="non-finite"):
        trainer.train()


def test_lr_schedule_resumes_on_curve(tmp_path):
    data = _dataset()
    kwargs = dict(lr_schedule="cosine", lr_min_fraction=0.05, lr_decay_steps=12,
                  save_best_model_only=False, early_stopping_restore_best_weights=False)
    full_hist = Trainer(_settings(tmp_path / "full", data, n_epoch=4, **kwargs)).train()
    Trainer(_settings(tmp_path / "part", data, n_epoch=2, **kwargs)).train()
    resumed = Trainer(_settings(tmp_path / "part", data, n_epoch=4, continue_training=True,
                                load=str(tmp_path / "part" / "out" / "model"), **kwargs))
    np.testing.assert_allclose(resumed.train()["lr"], full_hist["lr"][2:], rtol=1e-6)
    assert all(b < a for a, b in zip(full_hist["lr"], full_hist["lr"][1:]))


def _minority_dataset(n_pages=6, h=40, w=32):
    cmap = ColorMap({"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text"),
                     "(0, 255, 0)": (2, "image")})
    pages = []
    for i in range(n_pages):
        mask = np.zeros((h, w), np.uint8)
        if i == n_pages - 1:
            mask[5:35, 5:27] = 2
        else:
            mask[10:30, 5:25] = 1
        image = np.where(mask > 0, 200, 10).astype(np.uint8)
        pages.append(SingleData(image=image, binary=(mask > 0).astype(np.uint8), mask=mask))
    return Dataset(pages, cmap)


def test_balanced_sampling_boosts_minority_pages(tmp_path):
    data = _minority_dataset()
    trainer = Trainer(_settings(tmp_path, data, n_classes=3, balanced_sampling=True))
    rng = np.random.default_rng(0)
    minority = data.data[-1]
    counts = [sum(d is minority for b in trainer._bucketed_batches(data, 1, shuffle_rng=rng) for d in b)
              for _ in range(50)]
    assert np.mean(counts) > 1.8
    eval_batches = trainer._bucketed_batches(data, 1)
    assert sorted(id(d) for b in eval_batches for d in b) == sorted(id(d) for d in data.data)
    for d in data.data:
        d.mask = None
    lazy = Trainer(_settings(tmp_path, data, n_classes=3, balanced_sampling=True))
    with pytest.raises(ValueError, match="eager-loaded masks"):
        lazy._bucketed_batches(data, 1, shuffle_rng=np.random.default_rng(1))


def test_class_weighting_trains(tmp_path):
    trainer = Trainer(_settings(tmp_path, _minority_dataset(), n_classes=3, n_epoch=6,
                                class_weighting=1.0))
    freq = trainer._corpus_class_freq(trainer.settings.train_data.data)
    assert trainer._class_weights[2] == trainer._class_weights.max()
    assert np.isclose((freq * trainer._class_weights).sum(), 1.0)
    history = trainer.train()
    assert min(history["loss"]) < 0.7 * history["loss"][0]


@pytest.mark.parametrize("kwargs, item", [
    (dict(distributed=True), "item 12"),
    (dict(n_devices=2), "item 12"),
    (dict(checkpoint_backend="orbax"), "item 11"),
    (dict(auto_resume=True), "item 11"),
])
def test_unported_settings_name_their_item(tmp_path, kwargs, item):
    # ported: each setting trains (tests/test_torch_train_mesh*.py,
    # test_torch_distributed.py and test_torch_checkpoint_versioned.py hold
    # them against the JAX package); distributed at world size 1 over gloo
    from page_segmentation_tpu_torch.parallel import distributed

    if kwargs.get("distributed"):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        distributed.initialize(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        trainer = Trainer(_settings(tmp_path, _dataset(), n_epoch=1, **kwargs))
        history = trainer.train()
    finally:
        distributed.shutdown()
    assert np.isfinite(history["loss"]).all()
    if kwargs.get("distributed") or kwargs.get("n_devices"):
        assert trainer.mesh.devices.size == kwargs.get("n_devices", 1)
    assert (tmp_path / "out" / "model_orbax" / "0").exists() == (
        kwargs.get("checkpoint_backend") == "orbax")


# ------------------------------------------------------ against the JAX trainer
@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """A JAX init of FCNSkip (2 classes), written by the JAX save_checkpoint."""
    from page_segmentation_tpu.models.fcn import FCNSkip

    params = jax.jit(FCNSkip(n_classes=2).init)(jax.random.PRNGKey(0), jnp.zeros((1, 40, 32, 1)))
    path = str(tmp_path_factory.mktemp("init") / "model")
    jax_save_checkpoint(path, {"params": jax.device_get(params["params"])},
                        meta={"architecture": "fcn_skip", "n_classes": 2})
    return path


COMPARED = dict(n_epoch=3, save_best_model_only=False, early_stopping_restore_best_weights=False)


def _jax_settings(tmp_path, **kwargs):
    defaults = dict(n_epoch=3, n_classes=2, l_rate=1e-3, train_data=_dataset(jax_side=True),
                    validation_data=None, display=10, output_dir=str(tmp_path / "jax"), threads=1,
                    monitor=JaxMonitor.LOSS, early_stopping_max_performance_drops=0,
                    reduce_lr_on_plateau=False, save_best_model_only=False,
                    early_stopping_restore_best_weights=False)
    defaults.update(kwargs)
    return jax_trainer.TrainSettings(**defaults)


def _assert_params_close(got, want, rtol):
    for layer, leaves in want.items():
        for leaf, value in leaves.items():
            diff = np.linalg.norm(np.asarray(got[layer][leaf]) - np.asarray(value))
            assert diff <= rtol * max(np.linalg.norm(np.asarray(value)), 1e-12), (layer, leaf)


def test_three_epochs_and_cross_resume_match_jax(tmp_path, jax_init):
    full = jax_trainer.Trainer(_jax_settings(tmp_path / "full", load=jax_init))
    want = full.train()
    port = Trainer(_settings(tmp_path / "port", _dataset(), load=jax_init, **COMPARED))
    got = port.train()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    _assert_params_close(port.params, jax.device_get(full.params), 1e-3)

    # JAX trains 2 epochs; the port continues for the third from its checkpoint
    part = jax_trainer.Trainer(_jax_settings(tmp_path / "part", n_epoch=2, load=jax_init))
    part.train()
    resumed = Trainer(_settings(tmp_path / "port_resumed", _dataset(), continue_training=True,
                                load=str(tmp_path / "part" / "jax" / "model"), **COMPARED))
    tail = resumed.train()
    np.testing.assert_allclose(tail["loss"], want["loss"][2:], rtol=1e-3)
    _assert_params_close(resumed.params, jax.device_get(full.params), 1e-3)
    # the port's checkpoint loads in the JAX package's classifier
    classifier = JaxClassifier(n_classes=2, model_path=str(tmp_path / "port_resumed" / "out" / "model"))
    _assert_params_close(jax.device_get(classifier.params), resumed.params, 0.0)


def test_host_augmentation_matches_jax(tmp_path, jax_init):
    aug = dict(data_augmentation=True)
    jax_run = jax_trainer.Trainer(_jax_settings(
        tmp_path, load=jax_init, data_augmentation_settings=jax_trainer.AugmentationSettings(), **aug))
    port = Trainer(_settings(tmp_path / "port", _dataset(), load=jax_init, **COMPARED, **aug))
    # the batches both trainers draw for an epoch are bit-identical
    for trainer, data in ((jax_run, _dataset(jax_side=True)), (port, _dataset())):
        rng = np.random.default_rng([0, 1])
        trainer._drawn = [trainer._make_batch(b, augment=True, rng=rng)
                          for b in trainer._bucketed_batches(data, 1, shuffle_rng=rng)]
    assert len(port._drawn) == len(jax_run._drawn) == 3
    for got, want in zip(port._drawn, jax_run._drawn):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(port.train()["loss"], jax_run.train()["loss"], rtol=1e-3)


@pytest.mark.parametrize("order", [0, 1])
def test_device_warp_matches_jax(order):
    rng = np.random.default_rng(4)
    n, h, w = 3, 24, 20
    cfg = jax_augment_device.DeviceAugmentConfig(rotation_range=8.0, shear_range=3.0)
    mats = np.array(jax_augment_device._sample_matrices(jax.random.PRNGKey(2), n, h, w, cfg))
    if order == 0:
        pages = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    else:
        pages = rng.random((n, h, w)).astype(np.float32)
    want = np.stack([np.asarray(jax_augment_device._warp(jnp.asarray(p), jnp.asarray(m), order, h, w))
                     for p, m in zip(pages, mats)])
    got = augment_device._warp(torch.from_numpy(pages), torch.from_numpy(mats), order).numpy()
    if order == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_device_augmentation_keeps_classes_and_identity():
    g = torch.Generator().manual_seed(0)
    n, h, w = 2, 24, 20
    masks = torch.zeros((n, h, w), dtype=torch.int32)
    masks[:, 5:15, 4:12] = 1
    images = torch.rand((n, h, w, 1), generator=g)
    binaries = (masks > 0).to(torch.uint8)
    cfg = augment_device.DeviceAugmentConfig(horizontal_flip=True, vertical_flip=True)
    image_a, binary_a, mask_a = augment_device.augment_batch_on_device(prng_key(0), images, binaries,
                                                                       masks, cfg)
    assert image_a.shape == images.shape and mask_a.dtype == masks.dtype
    assert set(mask_a.unique().tolist()) <= set(masks.unique().tolist())
    identity = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]]).expand(n, 2, 3)
    assert torch.equal(augment_device._warp(masks, identity, 0), masks)
    assert torch.equal(augment_device._warp(images[..., 0], identity, 1), images[..., 0])


def test_settings_match_jax_fields_and_defaults():
    def plain(value):
        return value.value if hasattr(value, "value") else value

    for port_cls, jax_cls in ((TrainSettings, jax_trainer.TrainSettings),
                              (AugmentationSettings, jax_trainer.AugmentationSettings)):
        assert [f for f in port_cls._fields if f != "device"] == list(jax_cls._fields)
        for name, default in jax_cls._field_defaults.items():
            if name != "data_augmentation_settings":
                assert plain(port_cls._field_defaults[name]) == plain(default), name
    assert TrainSettings._field_defaults["device"] == "cuda"
    assert tuple(AugmentationSettings()) == tuple(jax_trainer.AugmentationSettings())
