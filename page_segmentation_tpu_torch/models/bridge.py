"""Weights bridge between the JAX variables and the port's state_dict.

The JAX variables are nested dicts of arrays: ``params`` (conv kernels HWIO
``(kh, kw, in, out)``, Keras conv-transpose kernels ``(kh, kw, out, in)``,
depthwise kernels ``(kh, kw, 1, C)``, biases, BatchNorm ``scale`` and
``bias``) and, for the BatchNorm families, ``batch_stats`` (``mean``,
``var``).  A leaf's path is its state_dict name: ``encoder/stage0_block0/
c1/conv/kernel`` is ``encoder.stage0_block0.c1.conv.weight``.  Every kernel
maps to torch's layout (conv ``(out, in / groups, kh, kw)``, conv-transpose
``(in, out, kh, kw)``) by ``transpose(3, 2, 0, 1)``, and back by
``transpose(2, 3, 1, 0)``; every other leaf keeps its name and values, the
``batch_stats`` leaves as the BatchNorm buffers.  Any tree of the params'
shapes (the optimizer's moments) maps the same way.

The int8 twins' calibrated ranges (``models/quant.py``) live in per-layer
buffers outside the state dict; :func:`amax_to_jax` and
:func:`amax_from_jax` carry them to and from the JAX package's ``amax``
collection, ``{"conv1": {"in": float32}, ...}``.

:func:`init_variables` draws a fresh module's variables from a seed: flax's
own weights, bit for bit, for every model (``models/flax_init.py``; each
layer's ``kernel_init`` names its law).  :func:`init_variables_numpy` draws
glorot-uniform kernels from numpy instead, for fixed test weights.
Checkpoints (``params.msgpack``) are read by ``train/checkpoint.py``.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_LEAVES = ("weight", "bias", "scale", "mean", "var")
_STATS = ("mean", "var")  # BatchNorm buffers: flax's batch_stats


def _flatten(tree, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, path + (key,))
        else:
            yield path + (key,), value


def _set(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX variables (``{"params": ..., "batch_stats": ...}``, the latter
    optional) or a bare params tree -> the port's float32 state_dict
    (parameters and, with ``batch_stats``, the BatchNorm buffers)."""
    collections = [tree["params"], tree.get("batch_stats", {})] if "params" in tree else [tree]
    state = {}
    for collection in collections:
        for path, leaf in _flatten(collection):
            arr = np.asarray(leaf, np.float32)
            name = ".".join(path[:-1])
            if path[-1] == "kernel":
                if arr.ndim != 4:
                    raise ValueError(f"{'/'.join(path)} must be 4-D, got {arr.shape}")
                state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
            else:
                state[f"{name}.{path[-1]}"] = torch.from_numpy(arr.copy())
    return state


def params_to_jax(state: Mapping[str, torch.Tensor]):
    """The port's state_dict (any device) -> the JAX tree of float32 numpy
    arrays: the bare params tree, or ``{"params", "batch_stats"}`` when the
    state holds BatchNorm buffers; the exact inverse of
    :func:`params_from_jax`."""
    params: dict = {}
    stats: dict = {}
    for name, value in state.items():
        *path, leaf = name.split(".")
        if leaf not in _LEAVES:
            raise ValueError(f"unexpected state_dict entry {name!r}")
        arr = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            if arr.ndim != 4:
                raise ValueError(f"{name} must be 4-D, got {arr.shape}")
            _set(params, path + ["kernel"], np.ascontiguousarray(arr.transpose(2, 3, 1, 0)))
        else:
            _set(stats if leaf in _STATS else params, path + [leaf], arr.copy())
    return {"params": params, "batch_stats": stats} if stats else params


def _quant_layers(module: torch.nn.Module) -> Dict[str, torch.nn.Module]:
    from .quant import _Quantized

    return {name: layer for name, layer in module.named_modules() if isinstance(layer, _Quantized)}


def amax_to_jax(module: torch.nn.Module) -> dict:
    """The calibrated ranges of an int8 twin as the JAX ``amax`` collection:
    ``{layer: {"in": float32}}``."""
    return {name: {"in": np.float32(layer.amax.item())}
            for name, layer in _quant_layers(module).items()}


def amax_from_jax(module: torch.nn.Module, amax: Mapping) -> None:
    """Set an int8 twin's ranges from an ``amax`` collection (the JAX
    package's or :func:`amax_to_jax`'s); the layer names must match."""
    layers = _quant_layers(module)
    if set(amax) != set(layers):
        raise ValueError(f"amax names {sorted(amax)} do not match the layers {sorted(layers)}")
    with torch.no_grad():
        for name, layer in layers.items():
            layer.amax.fill_(float(np.asarray(amax[name]["in"])))


def _jax_shape(name: str, tensor: torch.Tensor) -> Tuple[int, ...]:
    shape = tuple(tensor.shape)
    return tuple(shape[i] for i in (2, 3, 1, 0)) if name.endswith(".weight") else shape


def _variables(module: torch.nn.Module, kernel) -> dict:
    """The module's variables in the JAX layout: ``kernel(path, shape)`` for
    each kernel (its scope path, its JAX shape) in registration order, zero
    biases, BatchNorm scale 1, mean 0, var 1 (flax's initializers)."""
    params: dict = {}
    stats: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        shape = _jax_shape(name, p)
        if leaf == "weight":
            _set(params, path + ["kernel"], kernel(tuple(path), shape))
        else:
            fill = np.ones if leaf == "scale" else np.zeros
            _set(params, path + [leaf], fill(shape, np.float32))
    for name, b in module.named_buffers():
        *path, leaf = name.split(".")
        fill = np.ones if leaf == "var" else np.zeros
        _set(stats, path + [leaf], fill(tuple(b.shape), np.float32))
    return {"params": params, "batch_stats": stats} if stats else {"params": params}


def init_variables_numpy(module: torch.nn.Module, seed: int) -> dict:
    """Random variables of ``module`` in the JAX layout, not flax's draw:
    glorot-uniform kernels (fan in + out over the receptive field, whatever
    the layout or the layer's ``kernel_init``: conv, conv-transpose,
    depthwise), zero biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1;
    kernels drawn in the module's registration order from a
    ``numpy.random.Generator`` seeded with ``seed``.  Fixed weights for
    tests and checks; a fresh model takes :func:`init_variables`.  Only the
    module's shapes are read (a meta-device module will do)."""
    rng = np.random.default_rng(seed)

    def glorot(path, shape):
        kh, kw, a, b = shape
        limit = np.sqrt(6.0 / ((a + b) * kh * kw))
        return rng.uniform(-limit, limit, size=shape).astype(np.float32)

    return _variables(module, glorot)


def kernel_laws(module: torch.nn.Module) -> Dict[Tuple[str, ...], str]:
    """Each kernel's scope path (its state_dict name without ``.weight``,
    the JAX tree's path) and the flax initializer its layer names; a layer
    with a kernel that names none raises."""
    from .flax_init import LAWS

    laws = {}
    for name, layer in module.named_modules():
        if layer._parameters.get("weight") is None:
            continue
        law = getattr(layer, "kernel_init", None)
        if law not in LAWS:
            raise TypeError(f"{type(layer).__name__} {name!r} names no flax initializer "
                            f"(kernel_init {law!r}; known: {LAWS})")
        laws[tuple(name.split("."))] = law
    return laws


def init_variables(module: torch.nn.Module, seed: int) -> dict:
    """A fresh module's variables in the JAX layout: the JAX package's
    ``module.init({"params": PRNGKey(seed), ...})`` bit for bit, each kernel
    under its layer's ``kernel_init`` (``models/flax_init.py``).  Only the
    module's shapes are read."""
    from . import flax_init

    laws = kernel_laws(module)
    shapes = {tuple(name.split(".")[:-1]): _jax_shape(name, p)
              for name, p in module.named_parameters() if name.endswith(".weight")}
    kernels = [(path, law, shapes[path]) for path, law in laws.items()]
    values = dict(zip(laws, flax_init.draw(kernels, seed)))
    return _variables(module, lambda path, shape: values[path])


def zero_variables(module: torch.nn.Module) -> dict:
    """All-zero variables of ``module`` in the JAX layout (a template)."""
    variables = _variables(module, lambda path, shape: np.zeros(shape, np.float32))
    return {k: _zeros(tree) for k, tree in variables.items()}


def _zeros(tree):
    return {k: _zeros(v) if isinstance(v, dict) else np.zeros_like(v) for k, v in tree.items()}


def init_params_numpy(n_classes: int, seed: int, in_channels: int = 1, skips: bool = True):
    """Random FCNSkip (``skips``) or FCN params in the JAX layout
    (:func:`init_variables_numpy`)."""
    from .fcn import FCN, FCNSkip

    with torch.device("meta"):
        module = (FCNSkip if skips else FCN)(n_classes, in_channels=in_channels)
    return init_variables_numpy(module, seed)["params"]
