"""Export the port's variables to a Keras-legacy ``.h5`` weights file.

Counterpart of ``page_segmentation_tpu/models/h5_export.py``: models trained
here go back to reference-era tooling (Keras ``load_weights``), and either
package's importer reads the files.  ``variables`` is the JAX layout
(``models/bridge.py`` ``params_to_jax`` of a module's state_dict):

- grayscale archs (fcn/fcn_skip/unet/res_unet): layer names follow the
  Keras auto-naming of a freshly built reference model (conv2d, conv2d_1,
  ..., conv2d_transpose, ..., logits), so name-based loading also works.
- the BN families (mobile_net / image_res_net / effb0..b7): written from
  recorded manifests of the exact layout real Keras saves for a
  reference-shaped build, for Keras's by-order loader.

``h5py`` is imported when a file is written (``h5_import._h5py``): without
it the call raises ``ImportError`` naming the checkpoint route.
"""
from __future__ import annotations

import functools
import json
import logging
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from .h5_import import _ORDERINGS, _h5py
from .registry import Architecture

logger = logging.getLogger(__name__)


def _keras_layer_names(arch: Architecture) -> List[Tuple[str, str]]:
    """[(param name, keras layer name)] in build order."""
    ordering = _ORDERINGS[arch.value]
    out = []
    conv_count = 0
    deconv_count = 0
    for name in ordering:
        if name == "logits":
            out.append((name, "logits"))
        elif name.startswith("deconv"):
            keras = "conv2d_transpose" if deconv_count == 0 else f"conv2d_transpose_{deconv_count}"
            deconv_count += 1
            out.append((name, keras))
        else:
            keras = "conv2d" if conv_count == 0 else f"conv2d_{conv_count}"
            conv_count += 1
            out.append((name, keras))
    return out


def save_keras_h5(path: str, params, architecture: Architecture) -> None:
    """Write a legacy Keras weights .h5 for a grayscale architecture.

    For the BN families use :func:`save_keras_variables` (they need
    ``batch_stats`` as well as ``params``).
    """
    h5py = _h5py()

    if architecture.value not in _ORDERINGS:
        raise NotImplementedError(
            f"save_keras_h5 covers the grayscale architectures; use "
            f"save_keras_variables for {architecture.value}"
        )
    pairs = _keras_layer_names(architecture)

    with h5py.File(path, "w") as f:
        group = f.create_group("model_weights")
        layer_names = []
        for name, keras_name in pairs:
            entry = params[name]
            layer_group = group.create_group(keras_name)
            weight_names = []
            sub = layer_group.create_group(keras_name)
            sub.create_dataset("kernel", data=np.asarray(entry["kernel"], np.float32))
            weight_names.append(f"{keras_name}/kernel")
            if "bias" in entry:
                sub.create_dataset("bias", data=np.asarray(entry["bias"], np.float32))
                weight_names.append(f"{keras_name}/bias")
            layer_group.attrs["weight_names"] = np.array(
                [n.encode() for n in weight_names], dtype=object
            )
            layer_names.append(keras_name)
        group.attrs["layer_names"] = np.array([n.encode() for n in layer_names], dtype=object)
        group.attrs["backend"] = b"tensorflow"
        f.attrs["model_config"] = json.dumps(
            {"class_name": "Functional", "config": {"name": architecture.value}}
        )


# ------------------------------------------------------------------ families
#
# Manifest-driven export for mobile_net / image_res_net / effb0..b7.  The
# manifest records, per family, the ordered weighted-layer groups and the
# per-layer weight paths exactly as real Keras saves a reference-shaped
# model; a family resolver maps each recorded weight path back to the
# corresponding array (the inverse of models/*_import.py).  The port keeps
# its own copy of the manifests, beside this module.

_MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "h5_export_manifests.json")


@functools.lru_cache(maxsize=1)
def _manifests() -> Dict[str, dict]:
    with open(_MANIFEST_PATH) as f:
        return json.load(f)


def _load_manifest(family: str) -> dict:
    manifests = _manifests()
    if family not in manifests:
        raise NotImplementedError(f"no export manifest for {family}")
    return manifests[family]


def _bn_weight(bn_params, bn_stats, leaf: str) -> np.ndarray:
    if leaf == "gamma":
        return np.asarray(bn_params["scale"], np.float32)
    if leaf == "beta":
        return np.asarray(bn_params["bias"], np.float32)
    if leaf == "moving_mean":
        return np.asarray(bn_stats["mean"], np.float32)
    if leaf == "moving_variance":
        return np.asarray(bn_stats["var"], np.float32)
    raise KeyError(leaf)


def _fold_bn_scale(kernel: np.ndarray, bn_params, bn_stats, eps: float,
                   what: str) -> np.ndarray:
    """Fold a BatchNorm that the reference graph does not serialize into
    the preceding (bias-free) conv kernel.

    Only the multiplicative part ``a = gamma / sqrt(var + eps)`` is
    representable; the additive part ``c = beta - gamma * mean /
    sqrt(var + eps)`` has nowhere to go in a bias-free Keras conv and is
    dropped with a warning when non-negligible.  Weights imported from a
    reference ``.h5`` carry an exactly-identity BN here (see
    mobilenet_import.py), so round-trips are exact.
    """
    scale = np.asarray(bn_params["scale"], np.float64)
    var = np.asarray(bn_stats["var"], np.float64)
    mean = np.asarray(bn_stats["mean"], np.float64)
    bias = np.asarray(bn_params["bias"], np.float64)
    a = scale / np.sqrt(var + eps)
    c = bias - mean * a
    if np.abs(c).max() > 1e-5:
        logger.warning(
            ".h5 export: %s carries a BatchNorm shift (max |c| = %.3g) that the "
            "reference graph cannot represent; the shift is dropped and the "
            "exported model's deepest-skip activations differ by that constant",
            what, float(np.abs(c).max()),
        )
    return (np.asarray(kernel, np.float64) * a[None, None, None, :]).astype(np.float32)


class _MobileNetResolver:
    """reference model.py:95-148 — nested MobileNetV2 down-stack (one
    Keras layer group holding every backbone weight), five
    Conv2DTranspose upsamplers, 1x1 logits."""

    _UPS = ["up0", "up1", "up2", "up3", "up_final"]

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})
        self._up_index = -1
        self._bn_scopes: set = set()

    def begin_layer(self, entry):
        # group names are manifest data (recorded from a real Keras save):
        # the nested down-stack, then the five transpose upsamplers, logits
        if "transpose" in entry["name"]:
            self._up_index += 1
        elif entry["name"] != "logits":
            scopes = {w[0].split("/")[-2] for w in entry["weights"] if "/" in w[0]}
            self._bn_scopes = {s for s in scopes if s.endswith("_BN") or s == "bn_Conv1"}

    def _block_path(self, scope: str):
        if scope.startswith("expanded_conv"):
            return "block_0", scope[len("expanded_conv_"):]
        m = re.match(r"block_(\d+)_(.+)$", scope)
        if not m:
            raise KeyError(scope)
        return f"block_{m.group(1)}", m.group(2)

    def resolve(self, entry, weight_path: str) -> np.ndarray:
        scope, leaf = weight_path.split("/")[-2], weight_path.split("/")[-1]
        enc = self.params.get("encoder", {})
        est = self.stats.get("encoder", {})
        if scope == "Conv1":
            return np.asarray(enc["stem"]["conv"]["kernel"], np.float32)
        if scope == "bn_Conv1":
            return _bn_weight(enc["stem"]["bn"], est["stem"]["bn"], leaf)
        if scope.startswith(("block_", "expanded_conv")):
            block, part = self._block_path(scope)
            if part.endswith("_BN"):
                part = part[:-3]
                return _bn_weight(enc[block][part]["bn"], est[block][part]["bn"], leaf)
            if part == "depthwise":
                kernel = np.asarray(enc[block]["depthwise"]["dwconv"]["kernel"], np.float32)
                return np.transpose(kernel, (0, 1, 3, 2))  # (kh,kw,1,C)->(kh,kw,C,1)
            kernel = enc[block][part]["conv"]["kernel"]
            if f"{scope}_BN" not in self._bn_scopes:
                # the reference taps block_16_project PRE-BN (model.py:109),
                # so its BN never serializes — fold ours into the kernel
                return _fold_bn_scale(
                    kernel, enc[block][part]["bn"], est[block][part]["bn"],
                    eps=1e-3, what=f"encoder/{block}/{part}",
                )
            return np.asarray(kernel, np.float32)
        if scope == "logits":
            return np.asarray(self.params["logits"][leaf], np.float32)
        # decoder Conv2DTranspose groups, positional (names are counters)
        up = self.params[self._UPS[self._up_index]]
        return np.asarray(up[leaf], np.float32)


class _ResNetResolver:
    """reference model.py:320-366 — ResNet50 layers inline in the outer
    model, conv_block_simple decoder, 1x1 logits."""

    _BLOCK_RE = re.compile(r"^conv(\d)_block(\d+)_(\d)_(conv|bn)$")
    _DECODER_RE = re.compile(r"^(b_1|conv\d+_[12])_conv$")

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})

    def begin_layer(self, entry):
        pass

    def resolve(self, entry, weight_path: str) -> np.ndarray:
        scope, leaf = weight_path.split("/")[-2], weight_path.split("/")[-1]
        enc = self.params.get("encoder", {})
        est = self.stats.get("encoder", {})
        if scope == "conv1_conv":
            return np.asarray(enc["stem_conv"][leaf], np.float32)
        if scope == "conv1_bn":
            return _bn_weight(enc["stem_bn"], est["stem_bn"], leaf)
        m = self._BLOCK_RE.match(scope)
        if m:
            stage, block, idx, kind = (int(m.group(1)) - 2, int(m.group(2)) - 1,
                                       int(m.group(3)), m.group(4))
            sub = "shortcut" if idx == 0 else f"c{idx}"
            node = enc[f"stage{stage}_block{block}"][sub]
            if kind == "conv":
                return np.asarray(node["conv"][leaf], np.float32)
            return _bn_weight(node["bn"],
                              est[f"stage{stage}_block{block}"][sub]["bn"], leaf)
        m = self._DECODER_RE.match(scope)
        if m:
            return np.asarray(self.params[m.group(1)][leaf], np.float32)
        if scope == "logits":
            return np.asarray(self.params["logits"][leaf], np.float32)
        raise KeyError(f"unmapped res_net layer {scope}")


class _EffNetResolver:
    """reference model.py:368-407 — EfficientNet encoder inline (cut at
    block6a_expand), conv_block_simple decoder, 1x1 logits.  The
    tf.keras.applications preprocessing constants (normalization) come
    from the manifest."""

    _BLOCK_RE = re.compile(r"^block(\d+)([a-z])_(.+)$")
    _DECODER_RE = re.compile(r"^(b_1|conv\d+_[12])_conv$")

    def __init__(self, variables):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats", {})

    def begin_layer(self, entry):
        pass

    def resolve(self, entry, weight_path: str) -> np.ndarray:
        scope, leaf = weight_path.split("/")[-2], weight_path.split("/")[-1]
        if scope.startswith("normalization"):
            index = [w[0] for w in entry["weights"]].index(weight_path)
            shape = entry["weights"][index][1]
            return np.asarray(entry["values"][index], np.float32).reshape(shape)
        enc = self.params.get("encoder", {})
        est = self.stats.get("encoder", {})
        if scope == "stem_conv":
            return np.asarray(enc["stem"]["conv"]["kernel"], np.float32)
        if scope == "stem_bn":
            return _bn_weight(enc["stem"]["bn"], est["stem"]["bn"], leaf)
        m = self._BLOCK_RE.match(scope)
        if m:
            dst = f"s{int(m.group(1)) - 1}_b{ord(m.group(2)) - ord('a')}"
            part = m.group(3)
            if part == "expand_conv":
                return np.asarray(enc[dst]["expand"]["conv"]["kernel"], np.float32)
            if part == "expand_bn":
                return _bn_weight(enc[dst]["expand"]["bn"], est[dst]["expand"]["bn"], leaf)
            if part == "dwconv":
                kernel = np.asarray(enc[dst]["depthwise"]["conv"]["kernel"], np.float32)
                return np.transpose(kernel, (0, 1, 3, 2))
            if part == "bn":
                return _bn_weight(enc[dst]["depthwise"]["bn"], est[dst]["depthwise"]["bn"], leaf)
            if part == "se_reduce":
                return np.asarray(enc[dst]["se"]["reduce"][leaf], np.float32)
            if part == "se_expand":
                return np.asarray(enc[dst]["se"]["expand"][leaf], np.float32)
            if part == "project_conv":
                return np.asarray(enc[dst]["project"]["conv"]["kernel"], np.float32)
            if part == "project_bn":
                return _bn_weight(enc[dst]["project"]["bn"], est[dst]["project"]["bn"], leaf)
            raise KeyError(f"unmapped effnet block part {scope}")
        m = self._DECODER_RE.match(scope)
        if m:
            return np.asarray(self.params[m.group(1)][leaf], np.float32)
        if scope == "logits":
            return np.asarray(self.params["logits"][leaf], np.float32)
        raise KeyError(f"unmapped eff_net layer {scope}")


def save_keras_variables(path: str, variables, architecture: Architecture) -> None:
    """Write a legacy Keras ``.h5`` for any architecture.

    ``variables`` is the variables dict in the JAX layout ({"params": ..., and
    'batch_stats': ... for the BN families}).  The file loads into a
    freshly-built reference-shaped Keras model with
    ``model.load_weights(path)`` (topological by-order loading), and
    round-trips through ``load_keras_variables`` of either package.
    """
    h5py = _h5py()

    family = architecture.value
    if family in _ORDERINGS:
        save_keras_h5(path, variables["params"], architecture)
        return

    if family == "mobile_net":
        resolver = _MobileNetResolver(variables)
    elif family == "image_res_net":
        resolver = _ResNetResolver(variables)
    elif family.startswith("effb"):
        resolver = _EffNetResolver(variables)
    else:
        raise NotImplementedError(f".h5 export not supported for {family}")

    manifest = _load_manifest(family)
    with h5py.File(path, "w") as f:
        group = f.create_group("model_weights")
        layer_names = []
        for entry in manifest["layers"]:
            resolver.begin_layer(entry)
            layer_group = group.create_group(entry["name"])
            weight_names = []
            for weight_path, shape in entry["weights"]:
                array = resolver.resolve(entry, weight_path)
                if "logits" not in weight_path and list(array.shape) != list(shape):
                    raise ValueError(
                        f"{family} export: {weight_path} has shape "
                        f"{list(array.shape)}, manifest expects {shape}"
                    )
                layer_group.create_dataset(weight_path, data=array)
                weight_names.append(weight_path)
            layer_group.attrs["weight_names"] = np.array(
                [n.encode() for n in weight_names], dtype=object
            )
            layer_names.append(entry["name"])
        group.attrs["layer_names"] = np.array(
            [n.encode() for n in layer_names], dtype=object
        )
        group.attrs["backend"] = b"tensorflow"
        f.attrs["model_config"] = json.dumps(
            {"class_name": "Functional", "config": {"name": family}}
        )
