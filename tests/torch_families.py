"""Shared pieces of the port's family tests: seeded module weights with
calibrated BatchNorm statistics, page-like inputs, and the decisive-pixel
mask of bf16 comparisons."""
import numpy as np
import torch

from page_segmentation_tpu_torch.models import layers
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax, params_to_jax


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def size(arch):
    return (64, 96) if arch.stride_factor == 32 else (64, 64)


def calibrated(arch, x, dtype=torch.float32, seed=0):
    """The port's module with seeded weights, small nonzero biases and
    BatchNorm statistics calibrated on ``x``; and its JAX variables."""
    module = arch.model(3, dtype=dtype)
    variables = init_variables_numpy(module, seed)
    rng = np.random.default_rng(seed + 1)

    def jitter(tree):
        return {k: jitter(v) if isinstance(v, dict) else
                (0.05 * rng.standard_normal(v.shape)).astype(np.float32) if k == "bias" else v
                for k, v in tree.items()}

    variables["params"] = jitter(variables["params"])
    module.load_state_dict(params_from_jax(variables))
    layers.calibrate_batch_stats(module, nchw(x))
    back = params_to_jax(module.state_dict())
    return module, back if "params" in back else {"params": back}


def page_input(arch, n=2, seed=0):
    """Page-like input in the family's normalized range."""
    h, w = size(arch)
    rng = np.random.default_rng(seed)
    page = np.full((n, h, w), 230.0, np.float32)
    for _ in range(10):
        i, y, x = rng.integers(0, n), rng.integers(0, h - 8), rng.integers(0, w - 8)
        page[i, y : y + 8, x : x + rng.integers(3, 8)] = rng.uniform(10, 60)
    page += rng.normal(0, 3, page.shape).astype(np.float32)
    fn, rgb = arch.preprocess()
    x = page[..., None]
    return np.asarray(fn(np.repeat(x, 3, -1) if rgb else x), np.float32)


def decisive(logits, frac=0.05):
    """Pixels whose top-2 logit margin is at least ``frac`` of the largest
    |logit|: bf16's rounding cannot flip them."""
    top2 = np.sort(logits, -1)[..., -2:]
    return top2[..., 1] - top2[..., 0] >= frac * np.abs(logits).max()
