"""Keras-parity building blocks as torch modules (NCHW inside).

Counterparts of ``page_segmentation_tpu/models/layers.py``:

* :class:`TFConv` — ``Conv2D(padding='same')``, stride 1 (5x5 pads 2).
* :class:`TFConvTranspose` — ``Conv2DTranspose(padding='same')``: torch's
  full ``conv_transpose2d(stride=s, padding=0)`` cropped by
  ``pb = max(k - s, 0) // 2`` to ``H * s`` rows and columns.
* :func:`max_pool_same` — ``MaxPooling2D(padding='same')``.

Weights are kept in float32 (torch layout: conv ``(out, in, kh, kw)``,
conv-transpose ``(in, out, kh, kw)``) and cast to the compute dtype at each
call, as the flax modules cast their float32 params.  The bias is added
after the convolution, in the compute dtype, as flax adds it: a bias fused
into the convolution rounds once less, and the bf16 argmax then drifts
from the JAX modules' by ~0.1 %.  Convolutions are library calls (cuDNN on
the card): the JAX package leaves them to XLA.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class TFConv(nn.Module):
    """Stride-1 SAME convolution with bias and optional ReLU."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 relu: bool = False, dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = kernel_size
        self.weight = nn.Parameter(torch.zeros(features, in_features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        self.relu = relu
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        y = F.conv2d(x.to(dt), self.weight.to(dt), padding="same")
        y = y + self.bias.to(dt)[:, None, None]
        return F.relu(y) if self.relu else y


class TFConvTranspose(nn.Module):
    """Keras SAME transposed convolution with bias and optional ReLU."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), relu: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        kh, kw = kernel_size
        self.weight = nn.Parameter(torch.zeros(in_features, features, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features))
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.relu = relu
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        h, w = x.shape[-2:]
        full = F.conv_transpose2d(x.to(dt), self.weight.to(dt), stride=(sh, sw))
        ph, pw = max(kh - sh, 0) // 2, max(kw - sw, 0) // 2
        y = full[..., ph : ph + h * sh, pw : pw + w * sw] + self.bias.to(dt)[:, None, None]
        return F.relu(y) if self.relu else y


def max_pool_same(x, window: Tuple[int, int] = (2, 2), strides: Tuple[int, int] = (2, 2)):
    """``MaxPooling2D(padding='same')`` on NCHW: TF pads the spatial dims
    with -inf, the extra row/column at the bottom/right."""
    pads = []
    for size, k, s in zip(x.shape[-2:], window, strides):
        total = max((-(-size // s) - 1) * s + k - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, tuple(window), tuple(strides))
