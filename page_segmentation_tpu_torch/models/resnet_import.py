"""Import keras-applications ResNet50 weights into the ResNet50 encoder.

Counterpart of ``page_segmentation_tpu/models/resnet_import.py``:

    conv1_conv / conv1_bn                  -> encoder/stem_{conv,bn}
    conv{s+2}_block{b+1}_{1,2,3}_{conv,bn} -> encoder/stage{s}_block{b}/{c1,c2,c3}/{conv,bn}
    conv{s+2}_block{b+1}_0_{conv,bn}       -> .../shortcut/{conv,bn}
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .mobilenet_import import _bn_split, _set, replace_encoder

_BLOCKS = [3, 4, 6, 3]
# the decoder's conv blocks; Keras layer "<name>_conv"
_DECODER = ["b_1", "conv6_1", "conv6_2", "conv7_1", "conv7_2", "conv8_1", "conv8_2",
            "conv9_1", "conv9_2", "conv10_1", "conv10_2"]


def load_resnet50_encoder_h5(path_or_view):
    """(params, batch_stats) trees of the ResNet50 encoder."""
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    params: Dict = {}
    stats: Dict = {}

    def conv(dst, layer):
        weights = view.get(layer)
        entry = {"kernel": np.asarray(weights[0], np.float32)}
        if len(weights) > 1:
            entry["bias"] = np.asarray(weights[1], np.float32)
        _set(params, dst, entry)

    def bn(dst, layer):
        bn_params, bn_stats = _bn_split(view.get(layer))
        _set(params, dst, bn_params)
        _set(stats, dst, bn_stats)

    conv("stem_conv", "conv1_conv")
    bn("stem_bn", "conv1_bn")
    for stage, blocks in enumerate(_BLOCKS):
        for b in range(blocks):
            keras, mine = f"conv{stage + 2}_block{b + 1}", f"stage{stage}_block{b}"
            subs = ((0, "shortcut"),) if b == 0 else ()
            for idx, sub in subs + ((1, "c1"), (2, "c2"), (3, "c3")):
                conv(f"{mine}/{sub}/conv", f"{keras}_{idx}_conv")
                bn(f"{mine}/{sub}/bn", f"{keras}_{idx}_bn")
    return params, stats


def load_resnet_seg_h5(path_or_view):
    """Full-variables import of a reference-trained res_net model: the
    ResNet50 encoder, the BN-free decoder and the 1x1 logits."""
    from .h5_import import as_weights_view

    view = as_weights_view(path_or_view)
    enc_params, enc_stats = load_resnet50_encoder_h5(view)
    params: Dict = {"encoder": enc_params}
    for name in _DECODER + ["logits"]:
        kernel, bias = view.get(name if name == "logits" else f"{name}_conv")
        params[name] = {"kernel": np.asarray(kernel, np.float32), "bias": np.asarray(bias, np.float32)}
    return {"params": params, "batch_stats": {"encoder": enc_stats}}


def load_into_resnet_seg(variables, h5_path: str):
    """``variables`` of a ``ResNet50Seg`` with its encoder replaced by the
    weights of the Keras backbone ``.h5`` at ``h5_path`` (the decoder
    untouched)."""
    return replace_encoder(variables, *load_resnet50_encoder_h5(h5_path))
