"""Keras-parity building blocks as torch modules (NCHW inside).

Counterparts of ``page_segmentation_tpu/models/layers.py`` and of the flax
pieces the model families use:

* :class:`TFConv` — ``Conv2D`` / flax ``nn.Conv``: strides, TF/lax
  ``padding="SAME"`` (``total = max((ceil(H/s)-1)*s + k - H, 0)``, the
  odd pixel after), ``"VALID"`` or an explicit symmetric zero pad (Keras
  ``ZeroPadding2D`` + VALID), optional bias and ReLU, grouped (depthwise)
  kernels.
* :class:`TFConvTranspose` — ``Conv2DTranspose(padding='same')``: torch's
  full ``conv_transpose2d(stride=s, padding=0)`` cropped by
  ``pb = max(k - s, 0) // 2`` to ``H * s`` rows and columns.
* :class:`BatchNorm` — flax ``nn.BatchNorm`` exactly: batch statistics in
  float32 as ``E[x²] - E[x]²`` clipped at 0 (biased), the running update
  ``ra = m * ra + (1 - m) * batch``, and the normalization
  ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, cast to
  the compute dtype.
* :func:`max_pool_same`, :func:`upsample2x`, :func:`dropout`,
  :func:`gray_to_rgb`, :class:`GrayToRgb`, :class:`Padding2D`.
* :class:`Segmenter` — the base of every model: ``forward`` takes and
  returns NHWC like the JAX modules; ``forward_nchw`` is the net.

Every layer with a kernel names, as ``kernel_init``, the flax initializer
of its JAX counterpart (``models/flax_init.py``): ``glorot_uniform`` for
the Keras-style ``TFConv`` / ``TFConvTranspose``, ``lecun_normal`` for a
``TFConv`` that stands for flax's own ``nn.Conv``.

Weights are kept in float32 (torch layout: conv ``(out, in / groups, kh,
kw)``, conv-transpose ``(in, out, kh, kw)``) and cast to the compute dtype
at each call, as the flax modules cast their float32 params.  The bias is
added after the convolution, in the compute dtype, as flax adds it: a bias
fused into the convolution rounds once less, and the bf16 argmax then
drifts from the JAX modules' by ~0.1 %.  Convolutions are library calls
(cuDNN on the card): the JAX package leaves them to XLA.

Training mode is torch's ``module.training`` (the JAX modules'
``train=True``): :class:`BatchNorm` then normalizes with the batch's
statistics and leaves its new running statistics in ``updated_stats``
for ``train/steps.py`` to collect, and dropout draws its mask.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .flax_init import GLOROT_UNIFORM


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TF/lax SAME padding of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class TFConv(nn.Module):
    """Conv2D with SAME/VALID/explicit padding, strides, groups, optional
    bias and ReLU; ``kernel_init`` is the JAX counterpart's initializer
    (``lecun_normal`` for flax ``nn.Conv``)."""

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1), relu: bool = False, use_bias: bool = True,
                 padding: Union[str, int] = "SAME", groups: int = 1,
                 dtype: Optional[torch.dtype] = None, kernel_init: str = GLOROT_UNIFORM):
        super().__init__()
        self.kernel_init = kernel_init
        kh, kw = kernel_size
        self.weight = nn.Parameter(torch.zeros(features, in_features // groups, kh, kw))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.relu = relu
        self.dtype = dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.padding == "VALID":
            pad = 0
        elif isinstance(self.padding, int):
            pad = self.padding
        else:
            (top, bottom), (left, right) = (same_pads(n, k, s) for n, k, s in
                                            zip(x.shape[-2:], self.kernel_size, self.strides))
            if top == bottom and left == right:
                pad = (top, left)
            else:
                x, pad = F.pad(x, (left, right, top, bottom)), 0
        y = F.conv2d(x, w, stride=self.strides, padding=pad, groups=self.groups)
        if self.bias is not None:
            y = y + self.bias.to(dt)[:, None, None]
        return F.relu(y) if self.relu else y


class TFConvTranspose(nn.Module):
    """Keras SAME transposed convolution with bias and optional ReLU."""

    kernel_init = GLOROT_UNIFORM  # glorot_uniform(in_axis=3, out_axis=2): the same fans

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


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm`` over the channel dim of NCHW: params ``scale``
    and ``bias``, buffers ``mean`` and ``var`` (flax's ``batch_stats``)."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.updated_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # as flax: float64 stays
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            m = self.momentum
            with torch.no_grad():
                self.updated_stats = (m * self.mean + (1 - m) * mean.detach(),
                                      m * self.var + (1 - m) * var.detach())
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype or x.dtype)


def calibrate_batch_stats(module: nn.Module, x) -> None:
    """Set every BatchNorm's running statistics to those of one batch: one
    training-mode forward of NCHW ``x`` without gradients, each BatchNorm
    normalizing with (and keeping) its own input's batch statistics.

    Random-weight BatchNorm chains at mean 0 / var 1 amplify activations
    chaotically (EfficientNet-B7 most), and near-tied logits then make any
    argmax comparison meaningless; calibrated statistics keep every
    activation O(1)."""
    batch_norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    momenta = [bn.momentum for bn in batch_norms]
    module.train()
    try:
        for bn in batch_norms:
            bn.momentum = 0.0  # updated_stats = the batch's own statistics
        with torch.no_grad():
            module.forward_nchw(x)
            for bn in batch_norms:
                bn.mean.copy_(bn.updated_stats[0])
                bn.var.copy_(bn.updated_stats[1])
                bn.updated_stats = None
    finally:
        for bn, m in zip(batch_norms, momenta):
            bn.momentum = m
        module.eval()


def relu(x):
    return torch.relu(x)


def max_pool_same(x, window: Tuple[int, int] = (2, 2), strides: Tuple[int, int] = (2, 2)):
    """``MaxPooling2D(padding='same')`` on NCHW: TF pads the spatial dims
    with -inf, the extra row/column at the bottom/right."""
    (top, bottom), (left, right) = (same_pads(n, k, s) for n, k, s in
                                    zip(x.shape[-2:], window, strides))
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, tuple(window), tuple(strides))


def upsample2x(x):
    """``UpSampling2D(size=(2, 2))`` on NCHW: each pixel repeated 2×2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def dropout(x, rate: float, generator: Optional[torch.Generator] = None):
    """flax ``nn.Dropout``: keep each element with probability ``1 - rate``
    (a uniform draw below it, from ``generator``) and scale the kept ones by
    ``1 / (1 - rate)``."""
    keep_prob = 1.0 - rate
    draw = torch.rand(x.shape, generator=generator, device=x.device)
    return torch.where(draw < keep_prob, x / keep_prob, torch.zeros((), dtype=x.dtype, device=x.device))


def gray_to_rgb(x):
    """Channel-replicate a gray NHWC tensor to 3 channels (a 3-channel one
    passes through)."""
    if x.shape[-1] == 3:
        return x
    return torch.cat([x, x, x], dim=-1)


class GrayToRgb(nn.Module):
    """The serializable gray -> RGB layer (float32 out)."""

    def forward(self, x):
        return gray_to_rgb(x.to(torch.float32))


class Padding2D(nn.Module):
    """Zero-pad NHWC by a fixed amount at the bottom/right."""

    def __init__(self, padding: Tuple[int, int] = (1, 1)):
        super().__init__()
        self.padding = tuple(padding)

    def forward(self, x):
        ph, pw = self.padding
        return F.pad(x, (0, 0, 0, pw, 0, ph))


class Segmenter(nn.Module):
    """A per-pixel classifier: ``forward_nchw(x, dropout_rng=None)`` maps
    (N, C, H, W) to float32 logits (N, n_classes, H, W); ``forward`` does the
    same on NHWC, like the JAX modules.  ``dropout_rng`` (a
    ``torch.Generator``) drives the dropout of a model that has it, in
    training mode only."""

    def forward_nchw(self, x, dropout_rng: Optional[torch.Generator] = None):
        raise NotImplementedError

    def forward(self, image, dropout_rng: Optional[torch.Generator] = None):
        return self.forward_nchw(image.permute(0, 3, 1, 2), dropout_rng).permute(0, 2, 3, 1)


def conv_block_simple(in_features: int, features: int, dtype):
    """3×3 SAME conv + ReLU, the decoder block of the encoder families."""
    return TFConv(in_features, features, (3, 3), relu=True, dtype=dtype)
