"""Weights bridge between the JAX param tree and the port's state_dict.

The JAX FCN param tree is a nested dict ``{layer: {"kernel", "bias"}}`` of
arrays: conv kernels HWIO ``(kh, kw, in, out)`` and Keras conv-transpose
kernels ``(kh, kw, out, in)``.  Both map to torch's layout (conv
``(out, in, kh, kw)``, conv-transpose ``(in, out, kh, kw)``) by
``transpose(3, 2, 0, 1)``, and back by ``transpose(2, 3, 1, 0)``
(:func:`params_to_jax`).  Any tree of the params' shapes (the optimizer's
moments) maps the same way.

Checkpoints (``params.msgpack``) are read by ``train/checkpoint.py``.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_ENCODER = [("conv1", 1, 20), ("conv2", 20, 30), ("conv3", 30, 40), ("conv4", 40, 40),
            ("conv5", 40, 60), ("conv6", 60, 60), ("conv7", 60, 80)]
_DECODER_SKIP = [("deconv1", 80, 80, 5), ("deconv2", 80, 60, 2), ("deconv3", 120, 40, 5),
                 ("deconv4", 100, 30, 2), ("deconv5", 70, 20, 2)]


def params_from_jax(tree: Mapping[str, Mapping[str, np.ndarray]]) -> Dict[str, torch.Tensor]:
    """JAX param tree (``{"conv1": {"kernel", "bias"}, ...}``, optionally
    wrapped as ``{"params": tree}``) -> the port's float32 state_dict."""
    if "params" in tree:
        tree = tree["params"]
    state = {}
    for layer, leaves in tree.items():
        kernel = np.asarray(leaves["kernel"], np.float32)
        if kernel.ndim != 4:
            raise ValueError(f"{layer}/kernel must be 4-D, got {kernel.shape}")
        state[f"{layer}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.transpose(3, 2, 0, 1)))
        state[f"{layer}.bias"] = torch.from_numpy(np.asarray(leaves["bias"], np.float32).copy())
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's state_dict (``{"conv1.weight", "conv1.bias", ...}``, any
    device) -> the JAX param tree of float32 numpy arrays; the exact inverse
    of :func:`params_from_jax`."""
    tree: Dict[str, Dict[str, np.ndarray]] = {}
    for name, value in state.items():
        layer, leaf = name.rsplit(".", 1)
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{name} must be 4-D, got {arr.shape}")
            tree.setdefault(layer, {})["kernel"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            tree.setdefault(layer, {})["bias"] = arr.copy()
        else:
            raise ValueError(f"unexpected state_dict entry {name!r}")
    return tree


# decoder input widths of FCN, which joins no skip maps
_DECODER_PLAIN_IN = {"deconv3": 60, "deconv4": 40, "deconv5": 30}


def _layer_shapes(n_classes: int, in_channels: int = 1,
                  skips: bool = True) -> Dict[str, Tuple[int, ...]]:
    """FCNSkip (``skips``) or FCN kernel shapes in the JAX layout."""
    shapes = {}
    for name, cin, cout in _ENCODER:
        shapes[name] = (5, 5, in_channels if name == "conv1" else cin, cout)
    for name, cin, cout, k in _DECODER_SKIP:
        cin = cin if skips else _DECODER_PLAIN_IN.get(name, cin)
        shapes[name] = (k, k, cout, cin)  # Keras transpose layout (kh, kw, out, in)
    shapes["logits"] = (1, 1, 50 if skips else 20, n_classes)
    return shapes


def init_params_numpy(n_classes: int, seed: int, in_channels: int = 1, skips: bool = True):
    """Random FCNSkip (``skips``) or FCN params in the JAX layout:
    glorot-uniform kernels (fan in/out over the receptive field, as flax's
    initializer with the transpose layers' in_axis=3/out_axis=2) and zero
    biases, drawn from a ``numpy.random.Generator`` seeded with ``seed``."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, shape in _layer_shapes(n_classes, in_channels, skips).items():
        kh, kw, a, b = shape
        fan_sum = (a + b) * kh * kw  # fan_in + fan_out, either layout
        limit = np.sqrt(6.0 / fan_sum)
        tree[name] = {
            "kernel": rng.uniform(-limit, limit, size=shape).astype(np.float32),
            "bias": np.zeros(shape[2] if name.startswith("deconv") else shape[3], np.float32),
        }
    return tree
