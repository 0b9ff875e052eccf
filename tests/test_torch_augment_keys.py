"""The port's device augmentation (``data/augment_device.py``) against the
JAX function for the same key, on the CPU.  Both draw the same parameters
(``jax.random``'s bits, ``ops/prng.py``); the matrices then differ only by
the last ulp of float32 ``cos``/``sin`` and of XLA's contractions (within
1e-6 of each matrix's norm).  Against the JAX function run op by op
(``jax.disable_jit``) the port's bilinear image agrees everywhere within
1e-5.  Against the compiled JAX function, whose fused program contracts
multiply-adds, a pick moves where a source coordinate sits within an ulp
of a pixel boundary (the op-by-op JAX function then sides with the port):
against both, the image agrees within 1e-4 and the binary and mask are
equal on at least 99.99 % of the pixels (the counts are printed; one case
moves 2 of 128,000 image pixels against the compiled function).  A
shard's call with ``offset``/``total`` takes its rows of the whole batch's
draw.  The ``Trainer`` with ``device_augmentation`` against the JAX trainer
from the same seed (the same key chain, ``train/trainer.py``): two epochs of
FCNSkip, epoch losses to 1e-3."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.data import augment_device as jax_augment
from page_segmentation_tpu.train import trainer as jax_trainer
from page_segmentation_tpu_torch.data import augment_device
from page_segmentation_tpu_torch.ops.prng import prng_key
from page_segmentation_tpu_torch.train.trainer import AugmentationSettings, Trainer
from tests import test_torch_train_trainer as fcn_runs

N, H, W = 4, 200, 160
CONFIGS = {
    "default": {},
    "wide_flips": dict(rotation_range=8.0, shear_range=3.0, width_shift_range=0.1,
                       zoom_min=0.8, zoom_max=1.2, horizontal_flip=True, vertical_flip=True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[:H, :W]
    image = (np.sin(rows / 7.0) * np.cos(cols / 5.0))[None, ..., None] + 0.1 * rng.random((N, H, W, 1))
    mask = ((rows // 9 + cols // 13) % 3).astype(np.int32)[None] * np.ones((N, 1, 1), np.int32)
    binary = (mask == 1).astype(np.uint8)
    return image.astype(np.float32), binary, mask


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 3])
def test_augmentation_matches_jax_for_the_same_key(config, seed):
    jax_cfg = jax_augment.DeviceAugmentConfig(**CONFIGS[config])
    cfg = augment_device.DeviceAugmentConfig(**CONFIGS[config])
    image, binary, mask = _batch(seed)
    key = jax.random.PRNGKey(seed)
    args = (key, jnp.asarray(image), jnp.asarray(binary), jnp.asarray(mask), jax_cfg)
    want = [np.asarray(a) for a in jax_augment.augment_batch_on_device(*args)]
    with jax.disable_jit():
        eager = [np.asarray(a) for a in jax_augment.augment_batch_on_device(*args)]
    got = [a.numpy() for a in augment_device.augment_batch_on_device(
        prng_key(seed), torch.from_numpy(image), torch.from_numpy(binary), torch.from_numpy(mask), cfg)]
    np.testing.assert_allclose(got[0], eager[0], rtol=0, atol=1e-5)

    key_mat = jax.random.split(key, 3)[0]
    want_mats = np.asarray(jax_augment._sample_matrices(key_mat, N, H, W, jax_cfg), np.float64)
    got_mats = augment_device._sample_matrices(
        tuple(np.asarray(key_mat)), N, H, W, cfg).numpy().astype(np.float64)
    for g, w in zip(got_mats, want_mats):
        assert np.linalg.norm(g - w) <= 1e-6 * np.linalg.norm(w), (g, w)
    for mode, reference in (("op by op", eager), ("compiled", want)):
        for name, g, w in zip(("image", "binary", "mask"), got, reference):
            assert g.dtype == w.dtype
            differ = int((np.abs(g - w) > 1e-4).sum() if name == "image" else (g != w).sum())
            print(f"{config} seed {seed}, JAX {mode}: {name} differs on {differ} of {w.size} pixels")
            assert differ <= 1e-4 * w.size, (mode, name, differ)


def test_a_shard_takes_its_rows_of_the_whole_batch_draw():
    cfg = augment_device.DeviceAugmentConfig(**CONFIGS["wide_flips"])
    image, binary, mask = (torch.from_numpy(a) for a in _batch())
    whole = augment_device.augment_batch_on_device(prng_key(2), image, binary, mask, cfg)
    for start in (0, 2):
        rows = slice(start, start + 2)
        part = augment_device.augment_batch_on_device(prng_key(2), image[rows], binary[rows], mask[rows],
                                                      cfg, offset=start, total=N)
        for a, b in zip(part, whole):
            assert torch.equal(a, b[rows])


def test_fcn_two_epochs_with_device_augmentation_match_jax(tmp_path):
    augment = dict(rotation_range=8.0, shear_range=3.0, horizontal_flip=True, vertical_flip=True)
    kwargs = dict(n_epoch=2, seed=2, data_augmentation=True, device_augmentation=True)
    want = jax_trainer.Trainer(fcn_runs._jax_settings(
        tmp_path, data_augmentation_settings=jax_trainer.AugmentationSettings(**augment),
        **kwargs)).train()
    got = Trainer(fcn_runs._settings(tmp_path / "port", fcn_runs._dataset(),
                                     data_augmentation_settings=AugmentationSettings(**augment),
                                     **kwargs)).train()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-3)
    assert got["loss"][1] != got["loss"][0]
