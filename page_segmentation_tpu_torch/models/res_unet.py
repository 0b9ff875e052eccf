"""Residual U-Net (torch).

Counterpart of ``page_segmentation_tpu/models/res_unet.py`` ``ResUNet``:
channel plan 32/64/128/256/512, pre-activation residual blocks (ReLU ->
3×3 conv chains, no batch norm) with a 3×3 shortcut conv, stride-2 3×3
SAME convs entering ``enc2``-``enc5`` (TF's padding: the odd pixel after),
nearest 2× upsampling with ``[up, skip]`` concats, and 1×1 logits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import Segmenter, TFConv, upsample2x

FILTERS = [32, 64, 128, 256, 512]


class ResUNet(Segmenter):
    def __init__(self, n_classes: int, dtype: torch.dtype = torch.float32, in_channels: int = 1):
        super().__init__()
        self.n_classes = n_classes
        self.dtype = dt = dtype
        f = FILTERS

        def conv(name, cin, features, k=3, strides=(1, 1)):
            setattr(self, name, TFConv(cin, features, (k, k), strides=strides, dtype=dt))

        def residual(name, cin, features, strides=(1, 1)):
            conv(f"{name}_c1", cin, features, strides=strides)
            conv(f"{name}_c2", features, features)
            conv(f"{name}_sc", cin, features, strides=strides)

        conv("stem_c0", in_channels, f[0])
        conv("stem_c1", f[0], f[0])
        conv("stem_sc", in_channels, f[0], k=1)
        for i in range(1, 5):
            residual(f"enc{i + 1}", f[i - 1], f[i], strides=(2, 2))
        conv("bridge1", f[4], f[4])
        conv("bridge2", f[4], f[4])
        # decoder i joins the upsampled map with encoder skip 4 - i
        cin = f[4]
        for i, (features, skip) in enumerate(zip((f[4], f[3], f[2], f[1]), (f[3], f[2], f[1], f[0])),
                                             start=1):
            residual(f"dec{i}", cin + skip, features)
            cin = features
        self.logits = TFConv(f[1], n_classes, (1, 1), padding="VALID", dtype=dt)

    def _residual(self, name, x):
        res = getattr(self, f"{name}_c2")(F.relu(getattr(self, f"{name}_c1")(F.relu(x))))
        return getattr(self, f"{name}_sc")(x) + res

    def forward_nchw(self, x, dropout_rng=None):
        x = x.to(self.dtype)
        e = [self.stem_c1(F.relu(self.stem_c0(x))) + self.stem_sc(x)]
        for i in range(2, 6):
            e.append(self._residual(f"enc{i}", e[-1]))
        h = self.bridge2(F.relu(self.bridge1(F.relu(e[4]))))
        for i in range(1, 5):
            h = self._residual(f"dec{i}", torch.cat([upsample2x(h), e[4 - i]], dim=1))
        return self.logits(h).float()
