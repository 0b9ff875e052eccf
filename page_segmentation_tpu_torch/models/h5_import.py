"""Keras ``.h5`` model and weights importer.

Counterpart of ``page_segmentation_tpu/models/h5_import.py``: the reference
stores every model as Keras ``.h5``, so importing those weights gives a
reference-trained model to the port.  What comes out is the JAX package's
variables layout (``{"params", "batch_stats"?}`` of numpy arrays), which
``models/bridge.py`` ``params_from_jax`` loads into a module; both packages
read the same arrays from one file.

Mapping: the grayscale architectures list their weighted Keras layers in
build order, one per module of ``_ORDERINGS``; kernels copy straight
through (Conv2D ``(kh, kw, in, out)``, Conv2DTranspose ``(kh, kw, out,
in)``).  The three BatchNorm families (mobile_net, image_res_net,
effb0..b7) go through their own importers (``mobilenet_import.py``,
``resnet_import.py``, ``efficientnet_import.py``), encoder and decoder.

``h5py`` is imported inside the functions that read a file: a machine
without it (the card's) raises ``ImportError`` there.  Convert a ``.h5``
where h5py exists (:func:`load_keras_variables` then
``train/checkpoint.py`` ``save_checkpoint``), and load the checkpoint
directory on the card.
"""
from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from .registry import Architecture

# in-order names of the weighted layers of each grayscale module
_ORDERINGS = {
    "fcn_skip": ["conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "conv7",
                 "deconv1", "deconv2", "deconv3", "deconv4", "deconv5", "logits"],
    "fcn": ["conv1", "conv2", "conv3", "conv4", "conv5", "conv6", "conv7",
            "deconv1", "deconv2", "deconv3", "deconv4", "deconv5", "logits"],
    "unet": ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
             "conv4a", "conv4b", "conv5a", "conv5b",
             "up6", "conv6a", "conv6b", "up7", "conv7a", "conv7b",
             "up8", "conv8a", "conv8b", "up9", "conv9a", "conv9b", "logits"],
    # Keras lists layers in graph-topological order: inside a residual
    # block the shortcut conv serializes between the two path convs
    "res_unet": ["stem_c0", "stem_c1", "stem_sc",
                 "enc2_c1", "enc2_sc", "enc2_c2",
                 "enc3_c1", "enc3_sc", "enc3_c2",
                 "enc4_c1", "enc4_sc", "enc4_c2",
                 "enc5_c1", "enc5_sc", "enc5_c2",
                 "bridge1", "bridge2",
                 "dec1_c1", "dec1_sc", "dec1_c2",
                 "dec2_c1", "dec2_sc", "dec2_c2",
                 "dec3_c1", "dec3_sc", "dec3_c2",
                 "dec4_c1", "dec4_sc", "dec4_c2",
                 "logits"],
}

# architectures whose .h5 carries a BN-bearing encoder + decoder
_PRETRAINED_FAMILY = {
    "mobile_net": "mobilenet",
    "image_res_net": "resnet",
    **{f"effb{i}": "effnet" for i in range(8)},
}


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "reading or writing a Keras .h5 needs h5py, which is not installed: convert "
            "the .h5 where h5py exists (models/h5_import.py load_keras_variables, then "
            "train/checkpoint.py save_checkpoint) and load the checkpoint directory") from exc
    return h5py


def _decode(value):
    return value.decode() if isinstance(value, bytes) else value


class KerasWeights:
    """Flat, name-addressable view of every weighted layer in a Keras .h5.

    Layers inside nested functional sub-models (the reference mobile_net
    wraps its MobileNetV2 down-stack as one nested Model) are flattened into
    the same namespace: a weight path ``<...>/<layer>/<weight>`` registers
    under ``<layer>``, with weights in ``weight_names`` order (kernel/bias;
    BN gamma/beta/moving_mean/moving_variance).
    """

    def __init__(self, h5group):
        group = h5group["model_weights"] if "model_weights" in h5group else h5group
        self.order: List[str] = []
        self._weights = {}
        for layer_name in (_decode(n) for n in group.attrs["layer_names"]):
            layer_group = group[layer_name]
            for wn in (_decode(n) for n in layer_group.attrs.get("weight_names", [])):
                parts = wn.split("/")
                scope = parts[-2] if len(parts) >= 2 else layer_name
                if scope not in self._weights:
                    self._weights[scope] = []
                    self.order.append(scope)
                self._weights[scope].append(np.asarray(layer_group[wn]))

    @classmethod
    def from_file(cls, path: str) -> "KerasWeights":
        with _h5py().File(path, "r") as f:
            return cls(f)

    def get(self, name: str) -> List[np.ndarray]:
        return self._weights[name]

    def __contains__(self, name: str) -> bool:
        return name in self._weights

    def matching(self, predicate) -> List[str]:
        """Layer names satisfying ``predicate``, in build order."""
        return [n for n in self.order if predicate(n)]


def as_weights_view(path_or_view) -> KerasWeights:
    if isinstance(path_or_view, KerasWeights):
        return path_or_view
    return KerasWeights.from_file(path_or_view)


def _weighted_layers(h5file) -> List[Tuple[str, np.ndarray, Optional[np.ndarray]]]:
    """[(layer_name, kernel, bias)] in model build order."""
    group = h5file["model_weights"] if "model_weights" in h5file else h5file
    out = []
    for name in (_decode(n) for n in group.attrs["layer_names"]):
        layer_group = group[name]
        kernel = bias = None
        for wn in (_decode(n) for n in layer_group.attrs.get("weight_names", [])):
            arr = np.asarray(layer_group[wn])
            if "kernel" in wn:
                kernel = arr
            elif "bias" in wn:
                bias = arr
        if kernel is not None:
            out.append((name, kernel, bias))
    return out


def detect_architecture(h5file) -> Optional[Architecture]:
    """The architecture named in the file's ``model_config``, if any."""
    config = h5file.attrs.get("model_config")
    if config is None:
        return None
    try:
        name = json.loads(_decode(config)).get("config", {}).get("name", "")
    except (ValueError, AttributeError):
        return None
    try:
        return Architecture(name)
    except ValueError:
        for arch in Architecture:
            if arch.value in name:
                return arch
    return None


def load_keras_h5(path: str, architecture: Architecture, n_classes: int):
    """(params tree, detected Architecture or None) of a grayscale model."""
    with _h5py().File(path, "r") as f:
        detected = detect_architecture(f)
        arch = detected or architecture
        ordering = _ORDERINGS.get(arch.value)
        if ordering is None:
            raise NotImplementedError(f".h5 import not supported for {arch.value}")
        layers = _weighted_layers(f)

    if len(layers) != len(ordering):
        raise ValueError(
            f"Layer count mismatch importing {path}: "
            f"{len(layers)} weighted layers vs {len(ordering)} expected for {arch.value}"
        )
    params = {}
    for target, (_, kernel, bias) in zip(ordering, layers):
        entry = {"kernel": kernel.astype(np.float32)}
        if bias is not None:
            entry["bias"] = bias.astype(np.float32)
        params[target] = entry
    return params, detected


def load_keras_variables(path: str, architecture: Architecture, n_classes: int):
    """Full-variables import: ({'params', 'batch_stats'?}, detected).

    Grayscale architectures map conv layers in build order; the three
    BatchNorm families go through their family importers, which load
    encoder and decoder, so a reference-trained model predicts end to end.
    """
    with _h5py().File(path, "r") as f:
        detected = detect_architecture(f)
    arch = detected or architecture

    family = _PRETRAINED_FAMILY.get(arch.value)
    if family is None:
        params, detected = load_keras_h5(path, architecture, n_classes)
        return {"params": params}, detected

    view = as_weights_view(path)
    if family == "mobilenet":
        from .mobilenet_import import load_mobilenet_seg_h5

        return load_mobilenet_seg_h5(view), detected
    if family == "resnet":
        from .resnet_import import load_resnet_seg_h5

        return load_resnet_seg_h5(view), detected

    from .efficientnet_import import infer_effnet_variant, load_effnet_seg_h5
    from .mobilenet_import import _merge

    # the reference names every eff_net model 'effb0', so the true variant
    # comes from the weight structure, not the name
    arch = Architecture(infer_effnet_variant(view))
    imported = load_effnet_seg_h5(view)
    # the reference graph stops at block6a_expand, so the deeper encoder
    # blocks never serialize; the module still declares them (their outputs
    # are dead), so fill the holes with zeros of the module's own shapes
    template = _zero_variables(arch, n_classes)
    return {
        "params": _merge(template["params"], imported["params"]),
        "batch_stats": _merge(template.get("batch_stats", {}), imported["batch_stats"]),
    }, arch


def _zero_variables(arch: Architecture, n_classes: int):
    """Zero-filled variables of ``arch``'s module, from the shapes of its
    parameters and buffers (built on the meta device: no memory, no
    compute)."""
    import torch

    from .bridge import zero_variables

    with torch.device("meta"):
        module = arch.model(n_classes)
    return zero_variables(module)


def json_like(tree):
    """A nested mapping of arrays as nested plain dicts of the same arrays."""
    if isinstance(tree, np.ndarray):
        return tree
    return {k: json_like(v) for k, v in dict(tree).items()}


def load_encoder_into(variables, architecture: Architecture, h5_path: str):
    """Fine-tuning entry: replace the encoder subtree of freshly initialized
    segmentation variables with backbone weights from a keras-applications
    ``.h5`` (the decoder keeps its fresh init).

    Also accepts the msgpack encoder checkpoint directory that
    ``tools/provision_pretrained.py --out`` writes; that route needs no
    h5py, so it also works on the card."""
    family = _PRETRAINED_FAMILY.get(architecture.value)
    if family is None:
        raise ValueError(
            f"pretrained encoders apply to the mobilenet/resnet/efficientnet "
            f"families, not {architecture.value}"
        )
    if os.path.isdir(h5_path):
        from ..train.checkpoint import load_checkpoint
        from .mobilenet_import import _merge

        enc_vars, meta = load_checkpoint(h5_path)
        if meta.get("family") and meta["family"] != family:
            raise ValueError(
                f"encoder checkpoint holds a {meta['family']} backbone but the "
                f"architecture {architecture.value} needs {family}"
            )
        new_vars = dict(variables)
        for collection in ("params", "batch_stats"):
            tree = dict(new_vars.get(collection, {}))
            tree["encoder"] = _merge(
                dict(tree.get("encoder", {})),
                enc_vars.get(collection, {}).get("encoder", {}),
            )
            new_vars[collection] = tree
        return new_vars
    if family == "mobilenet":
        from .mobilenet_import import load_mobilenet_encoder_h5 as load
    elif family == "resnet":
        from .resnet_import import load_resnet50_encoder_h5 as load
    else:
        from .efficientnet_import import load_effnet_encoder_h5 as load
    from .mobilenet_import import replace_encoder

    return replace_encoder(variables, *load(h5_path))
