"""ResNet50-encoder U-Net (torch).

Counterpart of ``page_segmentation_tpu/models/resnet.py`` ``ResNet50Seg``:
keras-applications ResNet50 (a 3-pixel zero pad and a VALID 7×7/2 stem
conv, a -inf 1-pixel pad and a VALID 3×3/2 max pool, biases on every conv,
stride 2 on the 1×1 convs of the first block of stages conv3-conv5, BN
epsilon 1.001e-5 and flax's default momentum 0.99), skips at conv1_relu and
the end of each stage, and a decoder of 3×3 conv + ReLU blocks
(256/192/128/64/32) over nearest 2× upsampling with ``[up, skip]`` concats
down to full resolution, then 1×1 logits.  Module and parameter names
follow the JAX tree (``encoder.stage0_block0.c1.conv.weight``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Segmenter, TFConv, conv_block_simple, upsample2x

_EPS = 1.001e-5
_STAGES = [(64, 3), (128, 4), (256, 6), (512, 3)]


class _ConvBN(nn.Module):
    def __init__(self, cin, features, kernel=1, strides=1, act=True, padding="VALID", dtype=None):
        super().__init__()
        self.conv = TFConv(cin, features, (kernel, kernel), strides=(strides, strides),
                           padding=padding, dtype=dtype)
        self.bn = BatchNorm(features, epsilon=_EPS, dtype=dtype)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.relu(x) if self.act else x


class _Bottleneck(nn.Module):
    def __init__(self, cin, features, strides, downsample, dtype):
        super().__init__()
        if downsample:
            self.shortcut = _ConvBN(cin, features * 4, 1, strides, act=False, dtype=dtype)
        self.c1 = _ConvBN(cin, features, 1, strides, dtype=dtype)
        self.c2 = _ConvBN(features, features, 3, padding="SAME", dtype=dtype)
        self.c3 = _ConvBN(features, features * 4, 1, act=False, dtype=dtype)
        self.downsample = downsample

    def forward(self, x):
        shortcut = self.shortcut(x) if self.downsample else x
        return F.relu(shortcut + self.c3(self.c2(self.c1(x))))


class ResNet50Encoder(nn.Module):
    def __init__(self, in_channels: int = 3, dtype=None):
        super().__init__()
        self.stem_conv = TFConv(in_channels, 64, (7, 7), strides=(2, 2), padding=3, dtype=dtype)
        self.stem_bn = BatchNorm(64, epsilon=_EPS, dtype=dtype)
        cin = 64
        for stage, (features, blocks) in enumerate(_STAGES):
            for b in range(blocks):
                strides = 2 if (b == 0 and stage > 0) else 1
                setattr(self, f"stage{stage}_block{b}",
                        _Bottleneck(cin, features, strides, b == 0, dtype))
                cin = features * 4

    def forward(self, x):
        h = F.relu(self.stem_bn(self.stem_conv(x)))
        skips = [h]  # conv1_relu (H/2)
        h = F.max_pool2d(h, 3, 2, padding=1)  # pads with -inf, as pool1_pad + VALID
        for stage, (_, blocks) in enumerate(_STAGES):
            for b in range(blocks):
                h = getattr(self, f"stage{stage}_block{b}")(h)
            skips.append(h)  # conv{2..5}_block*_out
        return skips


# decoder (name, features, width of the skip it joins after upsampling)
_DECODER = [("conv6", 256, 1024), ("conv7", 192, 512), ("conv8", 128, 256),
            ("conv9", 64, 64), ("conv10", 32, None)]


class ResNet50Seg(Segmenter):
    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dt = dtype
        self.encoder = ResNet50Encoder(in_channels, dtype=dt)
        self.b_1 = conv_block_simple(2048, 256, dt)
        cin = 256
        for name, features, skip in _DECODER:
            skip = in_channels if skip is None else skip
            setattr(self, f"{name}_1", conv_block_simple(cin + skip, features, dt))
            setattr(self, f"{name}_2", conv_block_simple(features, features, dt))
            cin = features
        self.logits = TFConv(32, n_classes, (1, 1), padding="VALID", dtype=dt)

    def forward_nchw(self, x, dropout_rng=None):
        x = x.to(self.dtype)
        conv1, conv2, conv3, conv4, conv5 = self.encoder(x)
        h = self.b_1(conv5)
        for (name, _, _), skip in zip(_DECODER, (conv4, conv3, conv2, conv1, x)):
            h = torch.cat([upsample2x(h), skip], dim=1)
            h = getattr(self, f"{name}_2")(getattr(self, f"{name}_1")(h))
        return self.logits(h).float()
