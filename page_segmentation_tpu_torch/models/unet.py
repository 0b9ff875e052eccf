"""U-Net (torch).

Counterpart of ``page_segmentation_tpu/models/unet.py`` ``UNet``: double
3×3 convs of 64/128/256/512/1024 channels, 2×2 SAME max pools, dropout 0.5
on the two deepest blocks (training mode only), nearest 2× upsampling
followed by a 2×2 "up-conv", skip concats in the order ``[skip, up]``, and
1×1 logits.  Parameter names follow the JAX param tree (``conv1a.weight``
for ``conv1a/kernel``).  The dropouts are flax's ``Dropout_0`` and
``Dropout_1``: each draws under ``fold_in_static(dropout_rng, (name, 1))``,
the key flax's ``make_rng("dropout")`` gives it.
"""
from __future__ import annotations

import torch

from ..ops.prng import fold_in_static
from .layers import Segmenter, TFConv, dropout, max_pool_same, upsample2x

_WIDTHS = [64, 128, 256, 512, 1024]


class UNet(Segmenter):
    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32, in_channels: int = 1):
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dt = dtype

        def double_conv(name, cin, features):
            setattr(self, f"{name}a", TFConv(cin, features, (3, 3), relu=True, dtype=dt))
            setattr(self, f"{name}b", TFConv(features, features, (3, 3), relu=True, dtype=dt))

        cin = in_channels
        for i, features in enumerate(_WIDTHS, start=1):
            double_conv(f"conv{i}", cin, features)
            cin = features
        for i, features in zip(range(6, 10), reversed(_WIDTHS[:-1])):
            setattr(self, f"up{i}", TFConv(2 * features, features, (2, 2), relu=True, dtype=dt))
            double_conv(f"conv{i}", 2 * features, features)
        self.logits = TFConv(_WIDTHS[0], n_classes, (1, 1), padding="VALID", dtype=dt)

    def _double(self, name, x):
        return getattr(self, f"{name}b")(getattr(self, f"{name}a")(x))

    def forward_nchw(self, x, dropout_rng=None):
        def drop(h, name):
            if not self.training or dropout_rng is None:
                return h
            return dropout(h, 0.5, fold_in_static(dropout_rng, (name, 1)))

        x = x.to(self.dtype)
        conv1 = self._double("conv1", x)
        conv2 = self._double("conv2", max_pool_same(conv1))
        conv3 = self._double("conv3", max_pool_same(conv2))
        drop4 = drop(self._double("conv4", max_pool_same(conv3)), "Dropout_0")
        h = drop(self._double("conv5", max_pool_same(drop4)), "Dropout_1")
        for i, skip in zip(range(6, 10), (drop4, conv3, conv2, conv1)):
            up = getattr(self, f"up{i}")(upsample2x(h))
            h = self._double(f"conv{i}", torch.cat([skip, up], dim=1))
        return self.logits(h).float()
