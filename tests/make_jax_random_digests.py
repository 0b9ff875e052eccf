"""Frozen digests of ``jax.random``'s draws, for the port's kernel on the card.

``tests/jax_random_digests.json`` holds, drawn by JAX and flax:

* ``masks``: the SHA-256 of the keep mask (uint8, NCHW order) of flax
  ``nn.Dropout`` layers named as UNet's (``Dropout_0``, ``Dropout_1``) under
  ``rngs={"dropout": PRNGKey(seed)}``, at the shapes of UNet's dropouts in
  ``chip_smoke.py``'s train batch (8 pages bucketed to 432 x 304: drop4
  (8, 512, 54, 38), drop5 (8, 1024, 27, 19)), and at an odd shape with
  rate 0.1;
* ``uniform``: the SHA-256 of the float32 bytes of ``jax.random.uniform``
  for the device augmentation's ranges, at the batch's 8 values and at a
  large count;
* ``bernoulli``: the SHA-256 of ``jax.random.bernoulli(key, 0.5, (8,))``;
* ``unet_step``: the float32 loss of one UNet training step (``train=True``,
  ``train/metrics.py``'s loss) on a fixed small batch made with numpy, from
  ``UNet(3).init(PRNGKey(0))`` with dropout under ``PRNGKey(DROPOUT_SEED)``,
  and the same step's loss without dropout (the module in eval mode).

The card's machine has no JAX, so ``chip_smoke.py`` checks the port's draws
(the kernel and the plain version) against this file; ``tests/
test_torch_prng_digests.py`` regenerates it here and holds the port's plain
draws against it.  Regenerate (about 20 seconds):

    JAX_PLATFORMS=cpu python tests/make_jax_random_digests.py

Imports no JAX at module level: ``chip_smoke.py`` loads this file for its
constants and its port-side functions.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "jax_random_digests.json")
SEED = 0
UNET_BATCH = (8, 432, 304)  # chip_smoke.py: TRAIN_BATCH pages of its UNet train bucket
# (name, flax layer, NCHW shape, rate)
MASKS = (
    ("drop4", "Dropout_0", (8, 512, 54, 38), 0.5),
    ("drop5", "Dropout_1", (8, 1024, 27, 19), 0.5),
    ("odd", "Dropout_0", (3, 5, 7, 11), 0.1),
)
# (name, minval, maxval, count): DeviceAugmentConfig's and AugmentationSettings' ranges
UNIFORMS = (
    ("rotation", -2.5, 2.5, 8),
    ("shift", -0.025, 0.025, 8),
    ("shear", 0.0, 0.0, 8),
    ("zoom", 0.95, 1.05, 8),
    ("wide", -8.0, 8.0, 8),
    ("zoom_large", 0.95, 1.05, 1_000_003),
)
STEP_SHAPE = (2, 64, 64)  # UNet's stride, 2 pages
DROPOUT_SEED = 5


def sha(array) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def uniform_key(i: int):
    """The i-th of ``split(PRNGKey(SEED), len(UNIFORMS) + 1)``, as two ints;
    the last is the bernoulli's."""
    from page_segmentation_tpu_torch.ops.prng import prng_key, split

    return split(prng_key(SEED), len(UNIFORMS) + 1)[i]


def step_batch():
    """(image (N, H, W, 1) float32, mask (N, H, W) int32, weights) of the
    UNet step, from numpy."""
    rng = np.random.default_rng(SEED)
    n, h, w = STEP_SHAPE
    image = rng.random((n, h, w, 1), dtype=np.float32) * np.float32(255)  # logits well away from 0
    mask = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    weights = np.ones((n, h, w), np.float32)
    weights[:, -4:] = 0
    return image, mask, weights


def jax_digests() -> dict:
    """Every entry of the file, drawn by JAX and flax."""
    import jax
    import jax.numpy as jnp
    from flax import linen as nn

    from page_segmentation_tpu.models.unet import UNet
    from page_segmentation_tpu.train import metrics

    root = jax.random.PRNGKey(SEED)

    class Layers(nn.Module):
        """Two dropouts named as UNet's; the mask of the one asked for."""
        rate: float
        layer: str

        @nn.compact
        def __call__(self, x):
            first = nn.Dropout(self.rate, deterministic=False)(x)
            if self.layer == "Dropout_0":
                return first
            return nn.Dropout(self.rate, deterministic=False)(x)

    masks = {}
    for name, layer, (n, c, h, w), rate in MASKS:
        out = Layers(rate, layer).apply({}, jnp.ones((n, h, w, c), jnp.float32), rngs={"dropout": root})
        masks[name] = sha(np.asarray(out != 0, np.uint8).transpose(0, 3, 1, 2))
    keys = jax.random.split(root, len(UNIFORMS) + 1)
    uniform = {name: sha(np.asarray(jax.random.uniform(keys[i], (count,), jnp.float32, lo, hi)))
               for i, (name, lo, hi, count) in enumerate(UNIFORMS)}
    flips = sha(np.asarray(jax.random.bernoulli(keys[-1], 0.5, (8,)), np.uint8))

    image, mask, weights = step_batch()
    module = UNet(n_classes=3)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1,) + STEP_SHAPE[1:] + (1,)))

    @jax.jit
    def losses(variables):
        drop = module.apply(variables, image, train=True,
                            rngs={"dropout": jax.random.PRNGKey(DROPOUT_SEED)})
        plain = module.apply(variables, image, train=False)
        return (metrics.loss(mask, drop, weights=weights), metrics.loss(mask, plain, weights=weights))

    loss, no_dropout = (float(v) for v in losses(params))
    return {"masks": masks, "uniform": uniform, "bernoulli": flips,
            "unet_step": {"loss": loss, "loss_without_dropout": no_dropout}}


def port_masks(dropout, dtype, device) -> dict:
    """The port's mask digests: ``dropout(x, rate, key)`` on ones of
    ``dtype`` on ``device``, kept where nonzero."""
    import torch

    from page_segmentation_tpu_torch.ops.prng import fold_in_static, prng_key

    out = {}
    for name, layer, shape, rate in MASKS:
        x = torch.ones(shape, dtype=dtype, device=device)
        y = dropout(x, fold_in_static(prng_key(SEED), (layer, 1)), rate)
        out[name] = sha((y != 0).to(torch.uint8).cpu().numpy())
    return out


def port_uniforms(uniform, bernoulli, device) -> tuple:
    """The port's uniform and bernoulli digests, from ``uniform(key, shape,
    minval, maxval, device)`` and ``bernoulli(key, p, shape, device)``."""
    import torch

    digests = {name: sha(uniform(uniform_key(i), (count,), lo, hi, device).cpu().numpy())
               for i, (name, lo, hi, count) in enumerate(UNIFORMS)}
    flips = bernoulli(uniform_key(len(UNIFORMS)), 0.5, (8,), device)
    return digests, sha(flips.to(torch.uint8).cpu().numpy())


def port_unet_loss(device, dropout: bool = True) -> float:
    """The port's float32 UNet step loss on :func:`step_batch` from flax's
    ``PRNGKey(0)`` draw, with dropout under ``PRNGKey(DROPOUT_SEED)``."""
    import torch

    from page_segmentation_tpu_torch.models.bridge import init_variables, params_from_jax
    from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
    from page_segmentation_tpu_torch.ops.prng import prng_key
    from page_segmentation_tpu_torch.train.metrics import loss
    from page_segmentation_tpu_torch.train.steps import make_step_fns

    module = Architecture.UNET.model(3).to(device)
    module.load_state_dict(params_from_jax(init_variables(module, 0)))
    step, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), loss)
    image, mask, weights = step_batch()
    batch = {"image": torch.from_numpy(image), "mask": torch.from_numpy(mask),
             "weights": torch.from_numpy(weights), "binary": torch.ones(mask.shape, dtype=torch.uint8)}
    batch = {k: v.to(device) for k, v in batch.items()}
    key = prng_key(DROPOUT_SEED) if dropout else None
    return float(step.value_and_grad(dict(module.named_parameters()), {}, batch, key)[0])


def load() -> dict:
    with open(PATH) as f:
        return json.load(f)


def main() -> int:
    digests = jax_digests()
    with open(PATH, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"wrote {PATH}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main())
