"""Provision an ImageNet-pretrained encoder for fine-tuning.

Port of ``tools/provision_pretrained.py``.  The reference builds its
fine-tuning architectures with ``weights='imagenet'``, downloading from the
Keras model zoo; here the user supplies the backbone file, and this tool
validates and converts it:

    python -m page_segmentation_tpu_torch.tools.provision_pretrained backbone.h5 [--out ENCODER_DIR]

It detects the backbone family (MobileNetV2, ResNet50, EfficientNet B0-B7,
the variant read from the weights), imports the encoder through the port's
``models/*_import.py`` loaders (those of ``train --pretrained_encoder``),
prints the file's sha256 for provenance records and, with ``--out``, writes
a msgpack encoder checkpoint (``train/checkpoint.py`` ``save_checkpoint``)
that ``train --pretrained_encoder ENCODER_DIR`` loads without h5py, on the
card's machine too.

Reading the ``.h5`` needs h5py, which the card's machine lacks: convert
where h5py exists and copy the directory.  Keras writes such a file with,
for example, ``MobileNetV2(weights="imagenet", include_top=False).save(path)``.
The tool is host code and takes no device.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys


def detect_family(view) -> str:
    """Backbone family from the weight scopes."""
    if "Conv1" in view and "bn_Conv1" in view:
        return "mobilenet"
    if "conv1_conv" in view:
        return "resnet"
    if "stem_conv" in view:
        return "effnet"
    raise SystemExit(
        "unrecognized backbone: expected keras-applications MobileNetV2 "
        "(Conv1/bn_Conv1...), ResNet50 (conv1_conv...), or EfficientNet "
        "(stem_conv/blockXY_...) layer names"
    )


def count_leaves(tree) -> int:
    """The number of arrays in a nested dict."""
    if isinstance(tree, dict):
        return sum(count_leaves(v) for v in tree.values())
    return 1


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="validate + convert a keras-applications backbone .h5")
    parser.add_argument("weights", help="backbone .h5 (include_top=False save)")
    parser.add_argument("--out", default=None,
                        help="write a native msgpack encoder checkpoint here "
                             "(train --pretrained_encoder accepts the dir)")
    args = parser.parse_args(argv)

    with open(args.weights, "rb") as f:
        sha256 = hashlib.sha256(f.read()).hexdigest()

    from ..models.h5_import import as_weights_view

    view = as_weights_view(args.weights)
    family = detect_family(view)
    if family == "mobilenet":
        from ..models.mobilenet_import import load_mobilenet_encoder_h5

        params, stats = load_mobilenet_encoder_h5(view)
        variant = "mobilenetv2"
    elif family == "resnet":
        from ..models.resnet_import import load_resnet50_encoder_h5

        params, stats = load_resnet50_encoder_h5(view)
        variant = "resnet50"
    else:
        from ..models.efficientnet_import import infer_effnet_variant, load_effnet_encoder_h5

        variant = infer_effnet_variant(view)
        params, stats = load_effnet_encoder_h5(view)

    report = {
        "family": family,
        "variant": variant,
        "tensors": count_leaves(params) + count_leaves(stats),
        "sha256": sha256,
    }
    if args.out:
        from ..train.checkpoint import save_checkpoint

        save_checkpoint(
            args.out,
            {"params": {"encoder": params}, "batch_stats": {"encoder": stats}},
            meta={
                "pretrained_encoder": True,
                "family": family,
                "variant": variant,
                "source_sha256": sha256,
            },
        )
        report["converted_to"] = args.out
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
