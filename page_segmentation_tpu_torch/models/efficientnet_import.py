"""Import keras-applications EfficientNet weights into the EfficientNet
encoder.

Counterpart of ``page_segmentation_tpu/models/efficientnet_import.py``:

    stem_conv / stem_bn                  -> encoder/stem/{conv,bn}
    block{S}{L}_expand_conv/_expand_bn   -> encoder/s{S-1}_b{i}/expand/{conv,bn}
    block{S}{L}_dwconv / _bn             -> .../depthwise/{conv,bn}
    block{S}{L}_se_reduce / _se_expand   -> .../se/{reduce,expand}
    block{S}{L}_project_conv/_project_bn -> .../project/{conv,bn}

Keras EfficientNet normalizes inputs inside the model; the port, like the
JAX package, does the same outside with the architecture's 'torch'
preprocess mode.
"""
from __future__ import annotations

import re
from typing import Dict

import numpy as np

from .mobilenet_import import _bn_split, _set, replace_encoder

_BLOCK_RE = re.compile(r"^block(\d+)([a-z])_(.+)$")
_DECODER = ["b_1", "conv6_1", "conv6_2", "conv7_1", "conv7_2", "conv8_1", "conv8_2",
            "conv9_1", "conv9_2"]
# Keras block part -> (module path under the block, is a BN, is depthwise)
_PARTS = {
    "expand_conv": ("expand/conv", False, False),
    "expand_bn": ("expand/bn", True, False),
    "dwconv": ("depthwise/conv", False, True),
    "bn": ("depthwise/bn", True, False),
    "se_reduce": ("se/reduce", False, False),
    "se_expand": ("se/expand", False, False),
    "project_conv": ("project/conv", False, False),
    "project_bn": ("project/bn", True, False),
}


def load_effnet_encoder_h5(path_or_view):
    """(params, batch_stats) trees of the EfficientNet encoder (any variant:
    the block population comes from the layer names)."""
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    params: Dict = {}
    stats: Dict = {}

    def conv(dst, layer, depthwise=False):
        weights = view.get(layer)
        kernel = np.asarray(weights[0], np.float32)
        entry = {"kernel": np.transpose(kernel, (0, 1, 3, 2)) if depthwise else kernel}
        if len(weights) > 1:
            entry["bias"] = np.asarray(weights[1], np.float32)
        _set(params, dst, entry)

    def bn(dst, layer):
        bn_params, bn_stats = _bn_split(view.get(layer))
        _set(params, dst, bn_params)
        _set(stats, dst, bn_stats)

    conv("stem/conv", "stem_conv")
    bn("stem/bn", "stem_bn")
    for name in view.order:
        match = _BLOCK_RE.match(name)
        if not match or match.group(3) not in _PARTS:
            continue
        block = f"s{int(match.group(1)) - 1}_b{ord(match.group(2)) - ord('a')}"
        path, is_bn, depthwise = _PARTS[match.group(3)]
        if is_bn:
            bn(f"{block}/{path}", name)
        else:
            conv(f"{block}/{path}", name, depthwise)
    return params, stats


def infer_effnet_variant(path_or_view) -> str:
    """Which B0..B7 the file holds, from its block population.

    The reference names every eff_net model 'effb0' whatever its backbone
    (its default is EfficientNetB1), so the variant comes from the weights:
    depth scaling fixes the blocks per stage, width scaling the stem's
    channels; together they identify the variant even for files cut at the
    block6a skip.
    """
    from .efficientnet import _STAGES, _VARIANTS, _round_filters, _round_repeats
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    blocks_per_stage: Dict[int, int] = {}
    for name in view.order:
        match = _BLOCK_RE.match(name)
        if match and match.group(3) == "dwconv":
            stage = int(match.group(1)) - 1
            blocks_per_stage[stage] = max(
                blocks_per_stage.get(stage, 0), ord(match.group(2)) - ord("a") + 1
            )
    stem_channels = view.get("stem_conv")[0].shape[-1]

    for variant, (width, depth) in _VARIANTS.items():
        if _round_filters(32, width) != stem_channels:
            continue
        ok = True
        for stage, present in blocks_per_stage.items():
            expected = _round_repeats(_STAGES[stage][2], depth)
            # a segmentation file is cut at block6a: the deepest observed
            # stage may be partial, every earlier one must match exactly
            if stage == max(blocks_per_stage):
                ok = ok and present <= expected
            else:
                ok = ok and present == expected
        if ok:
            return variant
    raise ValueError(
        f"cannot identify an EfficientNet variant: stem={stem_channels} "
        f"blocks={blocks_per_stage}"
    )


def load_effnet_seg_h5(path_or_view):
    """Full-variables import of a reference-trained eff_net model: the
    EfficientNet encoder, the BN-free decoder and the 1x1 logits."""
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    enc_params, enc_stats = load_effnet_encoder_h5(view)
    params: Dict = {"encoder": enc_params}
    for name in _DECODER + ["logits"]:
        kernel, bias = view.get(name if name == "logits" else f"{name}_conv")
        params[name] = {"kernel": np.asarray(kernel, np.float32), "bias": np.asarray(bias, np.float32)}
    return {"params": params, "batch_stats": {"encoder": enc_stats}}


def load_into_effnet_seg(variables, h5_path: str):
    """``variables`` of a ``EffNetSeg`` with its encoder replaced by the
    weights of the Keras backbone ``.h5`` at ``h5_path`` (the decoder
    untouched)."""
    return replace_encoder(variables, *load_effnet_encoder_h5(h5_path))
