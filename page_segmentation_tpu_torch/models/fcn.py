"""FCN encoder-decoder per-pixel classifiers (torch).

Counterparts of ``page_segmentation_tpu/models/fcn.py`` ``FCNSkip`` and
``FCN``: the channel plan 20/30/40/40/60/60/80, 5x5 convs, stride-2 2x2
transpose convs, and (FCNSkip) the skip concats in the order
``[upsampled, skip]``.  The public layout is NHWC like the JAX module; the
net runs NCHW inside (:meth:`forward_nchw`).  ``dtype`` is the compute
dtype of every layer (float32 params cast per call); logits come back
float32.  Parameter names follow the JAX param tree (``conv1.weight`` for
``conv1/kernel``), so ``models/bridge.py`` maps one onto the other.

``s2d_stem=True`` runs conv1 and conv2 through the space-to-depth rewrite
(``models/s2d.py``) whenever H and W are multiples of 4, and the dense
stem otherwise, as the JAX modules do; the parameters are the same either
way.  The int8 twins (``models/quant.py``) reuse this graph with their own
layer classes (``conv_layer``, ``deconv_layer``).
"""
from __future__ import annotations

import torch

from .layers import Segmenter, TFConv, TFConvTranspose, max_pool_same


class _FCNBase(Segmenter):
    skips = False
    conv_layer = TFConv
    deconv_layer = TFConvTranspose

    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32,
                 s2d_stem: bool = False, in_channels: int = 1):
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dtype
        self.s2d_stem = s2d_stem
        self.s2d_runs = 0  # forwards whose stem took the s2d route
        dt = dtype
        conv, deconv = self.conv_layer, self.deconv_layer
        # skip concats widen each decoder input by the encoder map it joins
        s = self.skips
        self.conv1 = conv(in_channels, 20, (5, 5), relu=True, dtype=dt)
        self.conv2 = conv(20, 30, (5, 5), dtype=dt)
        self.conv3 = conv(30, 40, (5, 5), relu=True, dtype=dt)
        self.conv4 = conv(40, 40, (5, 5), dtype=dt)
        self.conv5 = conv(40, 60, (5, 5), relu=True, dtype=dt)
        self.conv6 = conv(60, 60, (5, 5), dtype=dt)
        self.conv7 = conv(60, 80, (5, 5), relu=True, dtype=dt)
        self.deconv1 = deconv(80, 80, (5, 5), relu=True, dtype=dt)
        self.deconv2 = deconv(80, 60, (2, 2), (2, 2), relu=True, dtype=dt)
        self.deconv3 = deconv(60 + 60 * s, 40, (5, 5), relu=True, dtype=dt)
        self.deconv4 = deconv(40 + 60 * s, 30, (2, 2), (2, 2), relu=True, dtype=dt)
        self.deconv5 = deconv(30 + 40 * s, 20, (2, 2), (2, 2), dtype=dt)
        self.logits = conv(20 + 30 * s, n_classes, (1, 1), dtype=dt)

    def _join(self, up, skip):
        return torch.cat([up, skip], dim=1) if self.skips else up

    def _stem(self, x):
        """conv1 (5x5, relu) + conv2 (5x5): the full-resolution stem, in the
        s2d layout when ``s2d_stem`` and H, W are multiples of 4."""
        from .s2d import s2d_stem, stem_applicable

        if self.s2d_stem and stem_applicable(x.shape):
            self.s2d_runs += 1
            return s2d_stem(x, [(self.conv1.weight, self.conv1.bias, True),
                                (self.conv2.weight, self.conv2.bias, False)],
                            block=4, dtype=self.dtype)
        return self.conv2(self.conv1(x))

    def forward_nchw(self, x, dropout_rng=None):
        """(N, C, H, W) -> float32 logits (N, n_classes, H, W); H, W
        multiples of 8."""
        x = x.to(self.dtype)
        conv2 = self._stem(x)
        conv3 = self.conv3(max_pool_same(conv2))
        conv4 = self.conv4(conv3)
        conv5 = self.conv5(max_pool_same(conv4))
        conv6 = self.conv6(conv5)
        conv7 = self.conv7(max_pool_same(conv6))

        deconv1 = self.deconv1(conv7)
        deconv2 = self._join(self.deconv2(deconv1), conv6)
        deconv3 = self._join(self.deconv3(deconv2), conv5)
        deconv4 = self._join(self.deconv4(deconv3), conv3)
        deconv5 = self._join(self.deconv5(deconv4), conv2)
        return self.logits(deconv5).float()


class FCNSkip(_FCNBase):
    """fcn_skip: the default architecture, with skip concats."""

    skips = True


class FCN(_FCNBase):
    """fcn: the same encoder, decoder without skip concats."""

    skips = False
