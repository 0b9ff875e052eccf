"""MobileNetV2-encoder U-Net (torch).

Counterpart of ``page_segmentation_tpu/models/mobilenet.py``
``MobileNetSeg``: the MobileNetV2 feature extractor (α = 1; relu6; bias-free
convs; depthwise 3×3 convs with TF's SAME padding at stride 2; BN momentum
0.999, epsilon 1e-3), skips at the expand activations of blocks 1, 3, 6 and
13 and the (post-BN) projection of block 16, a 512/256/128/64 stride-2
transposed-conv up-stack with ``[up, skip]`` concats, a final 60-filter
transposed conv and 1×1 logits.  Module and parameter names follow the JAX
tree (``encoder.block_1.depthwise.dwconv.weight``).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm, Segmenter, TFConv, TFConvTranspose


def _make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def _bn(features, dtype):
    return BatchNorm(features, momentum=0.999, epsilon=1e-3, dtype=dtype)


def relu6(x):
    return x.clamp(0.0, 6.0)


class _ConvBN(nn.Module):
    def __init__(self, cin, features, kernel=3, strides=1, act=True, dtype=None):
        super().__init__()
        self.conv = TFConv(cin, features, (kernel, kernel), strides=(strides, strides),
                           use_bias=False, dtype=dtype)
        self.bn = _bn(features, dtype)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return relu6(x) if self.act else x


class _DepthwiseBN(nn.Module):
    def __init__(self, channels, strides=1, dtype=None):
        super().__init__()
        self.dwconv = TFConv(channels, channels, (3, 3), strides=(strides, strides),
                             use_bias=False, groups=channels, dtype=dtype)
        self.bn = _bn(channels, dtype)

    def forward(self, x):
        return relu6(self.bn(self.dwconv(x)))


class _InvertedResidual(nn.Module):
    def __init__(self, cin, features, strides, expand, dtype):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self.expand = _ConvBN(cin, hidden, 1, dtype=dtype)
        self.depthwise = _DepthwiseBN(hidden, strides, dtype=dtype)
        self.project = _ConvBN(hidden, features, 1, act=False, dtype=dtype)
        self.has_expand = expand != 1
        self.residual = strides == 1 and cin == features

    def forward(self, x):
        expand_out = self.expand(x) if self.has_expand else None
        h = self.project(self.depthwise(x if expand_out is None else expand_out))
        return (x + h if self.residual else h), expand_out


# (expansion, features, repeats, first-stride) per MobileNetV2 stage
_STAGES = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
# blocks whose expand activation feeds a skip (block_16's projection is the last)
_SKIP_EXPANDS = {1, 3, 6, 13}


class MobileNetV2Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, dtype=None):
        super().__init__()
        self.stem = _ConvBN(in_channels, 32, 3, strides=2, dtype=dtype)
        cin, index = 32, 0
        for expansion, features, repeats, first_stride in _STAGES:
            for r in range(repeats):
                features = _make_divisible(features)
                setattr(self, f"block_{index}", _InvertedResidual(
                    cin, features, first_stride if r == 0 else 1, expansion, dtype))
                cin, index = features, index + 1
        self.n_blocks = index

    def forward(self, x):
        skips = []
        h = self.stem(x)
        for index in range(self.n_blocks):
            h, expand_out = getattr(self, f"block_{index}")(h)
            if index in _SKIP_EXPANDS:
                skips.append(expand_out)
        skips.append(h)  # block_16_project
        return skips


class MobileNetSeg(Segmenter):
    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dt = dtype
        self.encoder = MobileNetV2Encoder(in_channels, dtype=dt)
        # skip widths, deepest first: block 13, 6, 3, 1 expand activations
        cin = 320
        for i, (features, skip) in enumerate(zip([512, 256, 128, 64], [576, 192, 144, 96])):
            setattr(self, f"up{i}", TFConvTranspose(cin, features, (3, 3), (2, 2), relu=True, dtype=dt))
            cin = features + skip
        self.up_final = TFConvTranspose(cin, 60, (3, 3), (2, 2), relu=True, dtype=dt)
        self.logits = TFConv(60, n_classes, (1, 1), padding="VALID", dtype=dt)

    def forward_nchw(self, x, dropout_rng=None):
        skips = self.encoder(x.to(self.dtype))
        h = skips[-1]
        for i, skip in enumerate(reversed(skips[:-1])):
            h = torch.cat([getattr(self, f"up{i}")(h), skip], dim=1)
        return self.logits(self.up_final(h)).float()
