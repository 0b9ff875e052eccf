"""EfficientNet B0-B7 encoder U-Net (torch).

Counterpart of ``page_segmentation_tpu/models/efficientnet.py``
``EffNetSeg``: MBConv stages under the width/depth multipliers of each
variant (``_round_filters`` / ``_round_repeats``), swish, squeeze-excite,
bias-free SAME convs (depthwise k×k at stride 2 pads the odd pixel after),
BN momentum 0.99 and epsilon 1e-3; skips at the expand activations of the
first block of stages 2, 3, 4 and 6 (1-indexed), a 256/196/128/64 decoder of
3×3 conv + ReLU blocks over nearest 2× upsampling with ``[up, skip]``
concats, the last one with the input, then 1×1 logits.

The decoder reads only those four skips, so everything after block
``s5_b0``'s expand is dead code, which XLA drops from the JAX program.  In
eval mode the encoder stops there.  In training mode the JAX program still
updates the dead blocks' ``batch_stats``, so the encoder runs them under
``torch.no_grad()`` for their statistics alone, and checkpoints stay the
JAX package's.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import BatchNorm, Segmenter, TFConv, conv_block_simple, upsample2x

# (width_mult, depth_mult) per variant
_VARIANTS = {
    "effb0": (1.0, 1.0),
    "effb1": (1.0, 1.1),
    "effb2": (1.1, 1.2),
    "effb3": (1.2, 1.4),
    "effb4": (1.4, 1.8),
    "effb5": (1.6, 2.2),
    "effb6": (1.8, 2.6),
    "effb7": (2.0, 3.1),
}

# (expansion, features, repeats, stride, kernel) for the 7 EfficientNet stages
_STAGES = [
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
]
_SKIP_STAGES = (1, 2, 3, 5)  # 0-indexed; the last one's skip ends the live encoder


def _round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new_filters = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new_filters < 0.9 * filters:
        new_filters += divisor
    return int(new_filters)


def _round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def swish(x):
    return x * torch.sigmoid(x)


class _ConvBN(nn.Module):
    def __init__(self, cin, features, kernel=3, strides=1, act=True, groups=1, dtype=None):
        super().__init__()
        self.conv = TFConv(cin, features, (kernel, kernel), strides=(strides, strides),
                           use_bias=False, groups=groups, dtype=dtype)
        self.bn = BatchNorm(features, momentum=0.99, epsilon=1e-3, dtype=dtype)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return swish(x) if self.act else x


class _SqueezeExcite(nn.Module):
    def __init__(self, channels, reduced, dtype=None):
        super().__init__()
        self.reduce = TFConv(channels, reduced, (1, 1), dtype=dtype)
        self.expand = TFConv(reduced, channels, (1, 1), dtype=dtype)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.expand(swish(self.reduce(s))))


class _MBConv(nn.Module):
    def __init__(self, cin, features, kernel, strides, expand, dtype, se_ratio=0.25):
        super().__init__()
        hidden = cin * expand
        self.has_expand = expand != 1
        if self.has_expand:
            self.expand = _ConvBN(cin, hidden, 1, dtype=dtype)
        self.depthwise = _ConvBN(hidden, hidden, kernel, strides, groups=hidden, dtype=dtype)
        self.se = _SqueezeExcite(hidden, max(1, int(cin * se_ratio)), dtype=dtype)
        self.project = _ConvBN(hidden, features, 1, act=False, dtype=dtype)
        self.residual = strides == 1 and cin == features

    def tail(self, x, expand_out):
        """Everything after the expand: depthwise, squeeze-excite, project."""
        h = self.project(self.se(self.depthwise(x if expand_out is None else expand_out)))
        return x + h if self.residual else h

    def forward(self, x):
        expand_out = self.expand(x) if self.has_expand else None
        return self.tail(x, expand_out), expand_out


class EffNetEncoder(nn.Module):
    def __init__(self, variant: str = "effb0", in_channels: int = 3, dtype=None):
        super().__init__()
        width, depth = _VARIANTS[variant]
        cin = _round_filters(32, width)
        self.stem = _ConvBN(in_channels, cin, 3, 2, dtype=dtype)
        self.blocks = []
        self.skip_widths = []
        for stage, (expansion, features, repeats, stride, kernel) in enumerate(_STAGES):
            features = _round_filters(features, width)
            for r in range(_round_repeats(repeats, depth)):
                name = f"s{stage}_b{r}"
                setattr(self, name, _MBConv(cin, features, kernel, stride if r == 0 else 1,
                                            expansion, dtype))
                self.blocks.append(name)
                if r == 0 and stage in _SKIP_STAGES:
                    self.skip_widths.append(cin * expansion)
                cin = features
        self.skip_blocks = [f"s{stage}_b0" for stage in _SKIP_STAGES]

    def forward(self, x):
        """The four skips the decoder reads."""
        skips = []
        h = self.stem(x)
        for i, name in enumerate(self.blocks):
            block = getattr(self, name)
            if name == self.skip_blocks[-1]:
                expand_out = block.expand(h)
                skips.append(expand_out)
                if self.training:  # the dead tail, for its batch statistics only
                    with torch.no_grad():
                        h = block.tail(h, expand_out)
                        for rest in self.blocks[i + 1 :]:
                            h, _ = getattr(self, rest)(h)
                return skips
            h, expand_out = block(h)
            if name in self.skip_blocks:
                skips.append(expand_out)
        raise AssertionError("unreachable: the last skip stage is in every variant")


class EffNetSeg(Segmenter):
    def __init__(self, n_classes: int, variant: str = "effb0", dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        super().__init__()
        self.n_classes = n_classes
        self.variant = variant
        self.dtype = dt = dtype
        self.encoder = EffNetEncoder(variant, in_channels, dtype=dt)
        conv1, conv2, conv3, conv4 = self.encoder.skip_widths
        self.b_1 = conv_block_simple(conv4, 256, dt)
        cin = 256
        for name, features, skip in (("conv6", 256, conv3), ("conv7", 196, conv2),
                                     ("conv8", 128, conv1), ("conv9", 64, in_channels)):
            setattr(self, f"{name}_1", conv_block_simple(cin + skip, features, dt))
            setattr(self, f"{name}_2", conv_block_simple(features, features, dt))
            cin = features
        self.logits = TFConv(64, n_classes, (1, 1), padding="VALID", dtype=dt)

    def forward_nchw(self, x, dropout_rng=None):
        x = x.to(self.dtype)
        conv1, conv2, conv3, conv4 = self.encoder(x)
        h = self.b_1(conv4)
        for name, skip in (("conv6", conv3), ("conv7", conv2), ("conv8", conv1), ("conv9", x)):
            h = torch.cat([upsample2x(h), skip], dim=1)
            h = getattr(self, f"{name}_2")(getattr(self, f"{name}_1")(h))
        return self.logits(h).float()
