"""TF1 ``.meta`` checkpoint import.

Counterpart of the JAX package's ``models.tf1_import``.  A TF1
MetaGraphDef's ``trainable_variables`` collection keeps the order in which
the variables were created, so the by-order layer mapping of the Keras
importer (``h5_import._ORDERINGS``) applies without the TF1 variable names.
Each kernel's shape is checked against the port's own module of the target
architecture (``bridge.zero_variables``), and a checkpoint whose conv plan
differs is refused.  What comes out is the JAX package's params layout,
which ``PixelClassifier`` takes.

TensorFlow reads the checkpoint (nothing is executed) and is imported
inside :func:`load_tf1_checkpoint` only: a machine without it (the card's)
raises ``ImportError`` there.  Convert a checkpoint where TensorFlow exists
(:func:`load_tf1_checkpoint`, then ``train/checkpoint.py``
``save_checkpoint``) and load the checkpoint directory on the card.
TF1 ``conv2d_transpose`` kernels are ``(kh, kw, out, in)``, the layout the
by-order consumers expect, so values pass through unchanged.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from .h5_import import _ORDERINGS
from .registry import Architecture


def _resolve_prefix(path: str) -> Tuple[str, str]:
    """(checkpoint prefix, meta path) of a ``.meta`` path, a checkpoint
    prefix, or a ``.h5`` path whose sibling ``.meta`` exists."""
    if path.endswith(".meta"):
        return path[:-5], path
    if path.endswith(".h5"):
        return path[:-3], path[:-3] + ".meta"
    return path, path + ".meta"


def _tensorflow():
    try:
        import tensorflow as tf
    except ImportError as exc:
        raise ImportError(
            "reading a TF1 .meta checkpoint needs tensorflow, which is not installed: convert "
            "the checkpoint where tensorflow exists (models/tf1_import.py load_tf1_checkpoint, "
            "then train/checkpoint.py save_checkpoint) and load the checkpoint directory") from exc
    return tf


def ordered_trainable_names(meta_path: str) -> List[str]:
    """Variable names in creation order, from the MetaGraphDef's
    ``trainable_variables`` collection (no session, no graph import)."""
    _tensorflow()
    from tensorflow.core.framework import variable_pb2
    from tensorflow.core.protobuf import meta_graph_pb2

    graph = meta_graph_pb2.MetaGraphDef()
    with open(meta_path, "rb") as f:
        data = f.read()
    try:
        graph.ParseFromString(data)
    except Exception as exc:
        raise ValueError(f"{meta_path}: not a valid TF1 meta graph ({exc})") from exc
    collection = graph.collection_def.get("trainable_variables")
    if collection is None or not collection.bytes_list.value:
        raise ValueError(f"{meta_path}: no trainable_variables collection, not a trainable "
                         "TF1 checkpoint")
    names = []
    for item in collection.bytes_list.value:
        var = variable_pb2.VariableDef()
        var.ParseFromString(item)
        names.append(var.variable_name.split(":")[0])
    return names


def _pair_layers(names: List[str], values: List[np.ndarray]):
    """The ordered variables grouped into (name, kernel, bias) layers: a
    rank-4 kernel, then a rank-1 bias of its width when one follows."""
    layers = []
    i = 0
    while i < len(values):
        kernel_name, kernel = names[i], values[i]
        if kernel.ndim != 4:
            raise ValueError(f"variable '{kernel_name}' has rank {kernel.ndim}, expected a rank-4 "
                             "conv kernel: this TF1 graph is not a pure conv stack and cannot be "
                             "mapped by order")
        bias: Optional[np.ndarray] = None
        j = i + 1
        if (j < len(values) and values[j].ndim == 1
                and values[j].shape[0] in (kernel.shape[-1], kernel.shape[-2])):
            bias = values[j]
            j += 1
        layers.append((kernel_name, kernel, bias))
        i = j
    return layers


def load_tf1_checkpoint(path: str, architecture: Architecture, n_classes: int) -> dict:
    """Params (JAX layout, float32 numpy) of a TF1 checkpoint: ``path`` is
    its ``.meta`` file, its prefix, or the ``.h5`` path beside which the
    ``.meta`` lies."""
    tf = _tensorflow()
    prefix, meta_path = _resolve_prefix(str(path))
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"no TF1 meta graph at {meta_path}")
    ordering = _ORDERINGS.get(architecture.value)
    if ordering is None:
        raise NotImplementedError(f"TF1 import maps layers by order and is defined for the conv "
                                  f"families {sorted(_ORDERINGS)}, not {architecture.value}")
    names = ordered_trainable_names(meta_path)
    reader = tf.train.load_checkpoint(prefix)
    layers = _pair_layers(names, [np.asarray(reader.get_tensor(n)) for n in names])
    if len(layers) != len(ordering):
        raise ValueError(f"{meta_path}: {len(layers)} conv layers vs {len(ordering)} expected "
                         f"for {architecture.value}; wrong architecture?")

    import torch

    from .bridge import zero_variables

    with torch.device("meta"):
        template = zero_variables(architecture.model(n_classes))["params"]
    params = {}
    for target, (name, kernel, bias) in zip(ordering, layers):
        want = tuple(template[target]["kernel"].shape)
        if tuple(kernel.shape) != want:
            raise ValueError(f"{meta_path}: layer '{target}' kernel is {tuple(kernel.shape)}, "
                             f"expected {want} (variable '{name}'); refusing an ambiguous "
                             "by-order import")
        entry = {"kernel": kernel.astype(np.float32)}
        if bias is not None:
            entry["bias"] = bias.astype(np.float32)
        params[target] = entry
    return params
