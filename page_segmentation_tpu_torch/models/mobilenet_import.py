"""Import Keras-applications MobileNetV2 weights into the MobileNetV2 encoder.

Counterpart of ``page_segmentation_tpu/models/mobilenet_import.py``.  Name
mapping (Keras -> module path):

    Conv1 / bn_Conv1                        -> encoder/stem/{conv,bn}
    expanded_conv_{depthwise,project}(_BN)  -> encoder/block_0/...
    block_N_{expand,depthwise,project}(_BN) -> encoder/block_N/...

Keras BN weights (gamma, beta, moving_mean, moving_variance) become the
(scale, bias) params and the (mean, var) batch_stats; depthwise kernels
transpose (kh, kw, C, 1) -> (kh, kw, 1, C).  The reference taps
block_16_project before its BN, so a full mobile_net ``.h5`` never
serializes that BN: it comes in as an exact identity (var = 1 - eps, so the
1e-3 epsilon cancels), and the module's post-BN tap equals the reference's.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _bn_split(weights) -> Tuple[Dict, Dict]:
    gamma, beta, mean, var = (np.asarray(w, np.float32) for w in weights)
    return {"scale": gamma, "bias": beta}, {"mean": mean, "var": var}


def _set(tree: Dict, path: str, value: Dict) -> None:
    parts = path.split("/")
    node = tree
    for part in parts[:-1]:
        node = node.setdefault(part, {})
    node.setdefault(parts[-1], {}).update(value)


def _merge(base: Dict, override: Dict) -> Dict:
    out = dict(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = _merge(out[key], value)
        else:
            out[key] = value
    return out


def replace_encoder(variables, params: Dict, stats: Dict):
    """``variables`` with its ``encoder`` subtrees merged over by
    ``params`` and ``stats`` (the decoder untouched)."""
    new_vars = dict(variables)
    for collection, tree in (("params", params), ("batch_stats", stats)):
        merged = dict(new_vars.get(collection, {}))
        merged["encoder"] = _merge(dict(merged.get("encoder", {})), tree)
        new_vars[collection] = merged
    return new_vars


def load_mobilenet_encoder_h5(path_or_view):
    """(params, batch_stats) trees of the MobileNetV2 encoder (module name
    'encoder'), from a file path or a ``KerasWeights`` view (the backbone
    may be nested inside a full segmentation model)."""
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    params: Dict = {}
    stats: Dict = {}

    def conv_bn(dst: str, conv_layer: str, bn_layer: str, depthwise: bool = False):
        kernel = np.asarray(view.get(conv_layer)[0], np.float32)
        if depthwise:
            kernel = np.transpose(kernel, (0, 1, 3, 2))
        if bn_layer in view:
            bn_params, bn_stats = _bn_split(view.get(bn_layer))
        else:  # block_16_project, tapped before its BN by the reference
            channels = kernel.shape[-1]
            bn_params = {"scale": np.ones(channels, np.float32), "bias": np.zeros(channels, np.float32)}
            bn_stats = {"mean": np.zeros(channels, np.float32),
                        "var": np.full(channels, 1.0 - 1e-3, np.float32)}
        _set(params, dst, {"dwconv" if depthwise else "conv": {"kernel": kernel}, "bn": bn_params})
        _set(stats, dst, {"bn": bn_stats})

    conv_bn("stem", "Conv1", "bn_Conv1")
    block_index = 0
    while True:
        prefix = "expanded_conv" if block_index == 0 else f"block_{block_index}"
        if f"{prefix}_depthwise" not in view:
            break
        block = f"block_{block_index}"
        if f"{prefix}_expand" in view:
            conv_bn(f"{block}/expand", f"{prefix}_expand", f"{prefix}_expand_BN")
        conv_bn(f"{block}/depthwise", f"{prefix}_depthwise", f"{prefix}_depthwise_BN",
                depthwise=True)
        conv_bn(f"{block}/project", f"{prefix}_project", f"{prefix}_project_BN")
        block_index += 1
    return params, stats


def load_mobilenet_seg_h5(path_or_view):
    """Full-variables import of a reference-trained mobile_net model: the
    nested MobileNetV2 down-stack, the five Conv2DTranspose upsamplers and
    the 1x1 logits."""
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    enc_params, enc_stats = load_mobilenet_encoder_h5(view)
    params: Dict = {"encoder": enc_params}
    ups = view.matching(lambda n: "conv2d_transpose" in n)
    targets = ["up0", "up1", "up2", "up3", "up_final"]
    if len(ups) != len(targets):
        raise ValueError(
            f"mobile_net decoder expects {len(targets)} Conv2DTranspose "
            f"layers, found {len(ups)}: {ups}"
        )
    for dst, src in zip(targets + ["logits"], ups + ["logits"]):
        kernel, bias = view.get(src)
        params[dst] = {"kernel": np.asarray(kernel, np.float32), "bias": np.asarray(bias, np.float32)}
    return {"params": params, "batch_stats": {"encoder": enc_stats}}


def load_into_mobilenet_seg(variables, h5_path: str):
    """``variables`` of a ``MobileNetSeg`` with its encoder replaced by the
    weights of the Keras backbone ``.h5`` at ``h5_path`` (the decoder
    untouched)."""
    return replace_encoder(variables, *load_mobilenet_encoder_h5(h5_path))
