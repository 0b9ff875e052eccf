"""Frozen plain-PyTorch copies of the two architectures the benchmark runs.

Each architecture is a list of leaves (name, shape, kind) and a functional
forward over a dict of float32 tensors keyed by those names.  The names are
the ``state_dict`` keys of the program's modules, so one dict of weights,
made by the benchmark from the seed, is handed to the program and to this
reference alike.  Nothing here imports the program.

* ``fcnskip``: the reference's default ``fcn_skip`` (page-segmentation,
  ``lib/model.py:45``): 5x5 convolutions 20/30/40/40/60/60/80 with three 2x2
  max pools, Keras SAME transposed convolutions back up, skip concats
  ``[upsampled, skip]``, 1x1 logits.
* ``effb7`` (and the other ``effbN``): the reference's
  ``eff_net_fine_tuning`` U-Net over an EfficientNet encoder (Tan & Le,
  arXiv:1905.11946: MBConv stages under the width/depth multipliers, swish,
  squeeze-excite 0.25, BatchNorm eps 1e-3), skips at the expand outputs of
  the first block of stages 2, 3, 4 and 6 (1-indexed), a 256/196/128/64
  decoder of 3x3 conv + ReLU over nearest 2x upsampling, 1x1 logits.  The
  encoder's blocks after the last skip feed nothing: their leaves exist (the
  program's modules hold them) and the forward stops before them.

Convolutions pad as TensorFlow's SAME (the odd pixel after).  BatchNorm
normalizes as ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` with the
running statistics; :func:`calibrate` sets those from one batch.

``cast`` (identity by default) is applied to every convolution's input and
weight: the precision control passes a rounding to a lower precision.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Leaf = Tuple[str, Tuple[int, ...], str]  # (name, shape, kind)
Params = Dict[str, torch.Tensor]
Cast = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _same(x: torch.Tensor, cast: Cast) -> torch.Tensor:
    return x if cast is None else cast(x)


def same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """TensorFlow SAME padding of one spatial dim: (before, after)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b=None, stride: int = 1, groups: int = 1, padding: str = "SAME",
         cast: Cast = None):
    if padding == "SAME":
        (t, bo), (le, r) = (same_pads(n, k, stride) for n, k in zip(x.shape[-2:], w.shape[-2:]))
        x = F.pad(x, (le, r, t, bo))
    y = F.conv2d(_same(x, cast), _same(w, cast), stride=stride, groups=groups)
    return y if b is None else y + b[:, None, None]


def conv_transpose_same(x, w, b, stride: int, cast: Cast = None):
    """Keras ``Conv2DTranspose(padding='same')``: the full transposed
    convolution cropped to ``H * stride`` from ``max(k - s, 0) // 2``."""
    kh, kw = w.shape[-2:]
    h, wd = x.shape[-2:]
    full = F.conv_transpose2d(_same(x, cast), _same(w, cast), stride=stride)
    ph, pw = max(kh - stride, 0) // 2, max(kw - stride, 0) // 2
    return full[..., ph:ph + h * stride, pw:pw + wd * stride] + b[:, None, None]


def max_pool_same(x):
    (t, bo), (le, r) = (same_pads(n, 2, 2) for n in x.shape[-2:])
    if t or bo or le or r:
        x = F.pad(x, (le, r, t, bo), value=float("-inf"))
    return F.max_pool2d(x, 2, 2)


# ----------------------------------------------------------------- FCNSkip
_FCN_ENCODER = [("conv1", 1, 20, True), ("conv2", 20, 30, False), ("conv3", 30, 40, True),
                ("conv4", 40, 40, False), ("conv5", 40, 60, True), ("conv6", 60, 60, False),
                ("conv7", 60, 80, True)]
# (name, in, out, kernel, stride, relu); the inputs include the skip concats
_FCN_DECODER = [("deconv1", 80, 80, 5, 1, True), ("deconv2", 80, 60, 2, 2, True),
                ("deconv3", 120, 40, 5, 1, True), ("deconv4", 100, 30, 2, 2, True),
                ("deconv5", 70, 20, 2, 2, False)]


def fcnskip_leaves(n_classes: int = 3) -> List[Leaf]:
    leaves: List[Leaf] = []
    for name, cin, cout, relu in _FCN_ENCODER:
        leaves += [(f"{name}.weight", (cout, cin, 5, 5), "he" if relu else "lecun"),
                   (f"{name}.bias", (cout,), "bias")]
    for name, cin, cout, k, s, relu in _FCN_DECODER:
        kind = ("he" if relu else "lecun") + (f"_t{s}" if s > 1 else "_t1")
        leaves += [(f"{name}.weight", (cin, cout, k, k), kind), (f"{name}.bias", (cout,), "bias")]
    leaves += [("logits.weight", (n_classes, 50, 1, 1), "lecun"), ("logits.bias", (n_classes,), "bias")]
    return leaves


def fcnskip_forward(p: Params, x: torch.Tensor, cast: Cast = None) -> torch.Tensor:
    """(N, 1, H, W) float32, H and W multiples of 8 -> (N, C, H, W) logits."""
    def c(name, h, relu):
        y = conv(h, p[f"{name}.weight"], p[f"{name}.bias"], cast=cast)
        return F.relu(y) if relu else y

    def d(name, h, stride, relu):
        y = conv_transpose_same(h, p[f"{name}.weight"], p[f"{name}.bias"], stride, cast=cast)
        return F.relu(y) if relu else y

    c2 = c("conv2", c("conv1", x, True), False)
    c3 = c("conv3", max_pool_same(c2), True)
    c4 = c("conv4", c3, False)
    c5 = c("conv5", max_pool_same(c4), True)
    c6 = c("conv6", c5, False)
    c7 = c("conv7", max_pool_same(c6), True)
    h = d("deconv1", c7, 1, True)
    h = torch.cat([d("deconv2", h, 2, True), c6], 1)
    h = torch.cat([d("deconv3", h, 1, True), c5], 1)
    h = torch.cat([d("deconv4", h, 2, True), c3], 1)
    h = torch.cat([d("deconv5", h, 2, False), c2], 1)
    return conv(h, p["logits.weight"], p["logits.bias"], cast=cast)


# ------------------------------------------------------------ EfficientNet
_EFF_VARIANTS = {"effb0": (1.0, 1.0), "effb1": (1.0, 1.1), "effb2": (1.1, 1.2),
                 "effb3": (1.2, 1.4), "effb4": (1.4, 1.8), "effb5": (1.6, 2.2),
                 "effb6": (1.8, 2.6), "effb7": (2.0, 3.1)}
# (expansion, features, repeats, stride, kernel) of the seven stages
_EFF_STAGES = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
               (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3)]
_EFF_SKIP_STAGES = (1, 2, 3, 5)
_EFF_DECODER = (("conv6", 256), ("conv7", 196), ("conv8", 128), ("conv9", 64))
BN_EPS = 1e-3


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth: float) -> int:
    return int(math.ceil(depth * repeats))


def effnet_blocks(variant: str):
    """[(name, cin, features, kernel, stride, expansion, skip)] of the encoder."""
    width, depth = _EFF_VARIANTS[variant]
    cin = round_filters(32, width)
    blocks = []
    for stage, (expansion, features, repeats, stride, kernel) in enumerate(_EFF_STAGES):
        features = round_filters(features, width)
        for r in range(round_repeats(repeats, depth)):
            blocks.append((f"s{stage}_b{r}", cin, features, kernel, stride if r == 0 else 1,
                           expansion, r == 0 and stage in _EFF_SKIP_STAGES))
            cin = features
    return blocks


def _bn_leaves(prefix: str, ch: int) -> List[Leaf]:
    return [(f"{prefix}.scale", (ch,), "bn_scale"), (f"{prefix}.bias", (ch,), "bias"),
            (f"{prefix}.mean", (ch,), "bn_mean"), (f"{prefix}.var", (ch,), "bn_var")]


def effnet_leaves(variant: str = "effb7", n_classes: int = 3, in_channels: int = 3) -> List[Leaf]:
    stem = round_filters(32, _EFF_VARIANTS[variant][0])
    leaves: List[Leaf] = [("encoder.stem.conv.weight", (stem, in_channels, 3, 3), "lecun")]
    leaves += _bn_leaves("encoder.stem.bn", stem)
    skips = []
    for name, cin, features, kernel, _, expansion, skip in effnet_blocks(variant):
        pre, hidden = f"encoder.{name}", cin * expansion
        if expansion != 1:
            leaves.append((f"{pre}.expand.conv.weight", (hidden, cin, 1, 1), "lecun"))
            leaves += _bn_leaves(f"{pre}.expand.bn", hidden)
        leaves.append((f"{pre}.depthwise.conv.weight", (hidden, 1, kernel, kernel), "lecun"))
        leaves += _bn_leaves(f"{pre}.depthwise.bn", hidden)
        reduced = max(1, int(cin * 0.25))
        leaves += [(f"{pre}.se.reduce.weight", (reduced, hidden, 1, 1), "lecun"),
                   (f"{pre}.se.reduce.bias", (reduced,), "bias"),
                   (f"{pre}.se.expand.weight", (hidden, reduced, 1, 1), "lecun"),
                   (f"{pre}.se.expand.bias", (hidden,), "bias"),
                   (f"{pre}.project.conv.weight", (features, hidden, 1, 1), "lecun")]
        leaves += _bn_leaves(f"{pre}.project.bn", features)
        if skip:
            skips.append(hidden)
    conv1, conv2, conv3, conv4 = skips
    leaves += [("b_1.weight", (256, conv4, 3, 3), "he"), ("b_1.bias", (256,), "bias")]
    cin = 256
    for (name, features), skip in zip(_EFF_DECODER, (conv3, conv2, conv1, in_channels)):
        leaves += [(f"{name}_1.weight", (features, cin + skip, 3, 3), "he"),
                   (f"{name}_1.bias", (features,), "bias"),
                   (f"{name}_2.weight", (features, features, 3, 3), "he"),
                   (f"{name}_2.bias", (features,), "bias")]
        cin = features
    leaves += [("logits.weight", (n_classes, 64, 1, 1), "lecun"), ("logits.bias", (n_classes,), "bias")]
    return leaves


def _swish(x):
    return x * torch.sigmoid(x)


class _BatchNorms:
    """Applies each BatchNorm with the running statistics, or, calibrating,
    with (and into) the statistics of the batch it sees."""

    def __init__(self, p: Params, calibrate: bool):
        self.p, self.calibrate = p, calibrate

    def __call__(self, prefix: str, x):
        p = self.p
        if self.calibrate:
            mean = x.mean(dim=(0, 2, 3))
            var = ((x * x).mean(dim=(0, 2, 3)) - mean * mean).clamp_min(0.0)
            p[f"{prefix}.mean"].copy_(mean)
            p[f"{prefix}.var"].copy_(var)
        mean, var = p[f"{prefix}.mean"], p[f"{prefix}.var"]
        mul = torch.rsqrt(var + BN_EPS) * p[f"{prefix}.scale"]
        return (x - mean[:, None, None]) * mul[:, None, None] + p[f"{prefix}.bias"][:, None, None]


def effnet_forward(p: Params, x: torch.Tensor, variant: str = "effb7", cast: Cast = None,
                   calibrate: bool = False) -> torch.Tensor:
    """(N, 3, H, W) preprocessed float32, H and W multiples of 32 -> logits.
    ``calibrate`` first sets every live BatchNorm's statistics to its input
    batch's (biased variance) and normalizes with them."""
    bn = _BatchNorms(p, calibrate)

    def conv_bn(prefix, h, stride=1, groups=1, act=True):
        h = bn(f"{prefix}.bn", conv(h, p[f"{prefix}.conv.weight"], stride=stride, groups=groups,
                                    cast=cast))
        return _swish(h) if act else h

    h = conv_bn("encoder.stem", x, stride=2)
    skips = []
    blocks = effnet_blocks(variant)
    last_skip = [b[0] for b in blocks if b[6]][-1]
    for name, cin, features, kernel, stride, expansion, skip in blocks:
        pre, hidden = f"encoder.{name}", cin * expansion
        e = conv_bn(f"{pre}.expand", h) if expansion != 1 else h
        if skip:
            skips.append(e)
        if name == last_skip:
            break
        y = conv_bn(f"{pre}.depthwise", e, stride=stride, groups=hidden)
        s = y.mean(dim=(2, 3), keepdim=True)
        s = _swish(conv(s, p[f"{pre}.se.reduce.weight"], p[f"{pre}.se.reduce.bias"], cast=cast))
        y = y * torch.sigmoid(conv(s, p[f"{pre}.se.expand.weight"], p[f"{pre}.se.expand.bias"],
                                   cast=cast))
        y = conv_bn(f"{pre}.project", y, act=False)
        h = h + y if stride == 1 and cin == features else y
    conv1, conv2, conv3, conv4 = skips
    h = F.relu(conv(conv4, p["b_1.weight"], p["b_1.bias"], cast=cast))
    for (name, _), skip in zip(_EFF_DECODER, (conv3, conv2, conv1, x)):
        h = torch.cat([F.interpolate(h, scale_factor=2, mode="nearest"), skip], 1)
        h = F.relu(conv(h, p[f"{name}_1.weight"], p[f"{name}_1.bias"], cast=cast))
        h = F.relu(conv(h, p[f"{name}_2.weight"], p[f"{name}_2.bias"], cast=cast))
    return conv(h, p["logits.weight"], p["logits.bias"], padding="VALID", cast=cast)


# ------------------------------------------------------------ the registry
ARCHITECTURES = {
    "fcn_skip": (lambda n: fcnskip_leaves(n), lambda p, x, cast=None: fcnskip_forward(p, x, cast)),
}
for _v in _EFF_VARIANTS:
    ARCHITECTURES[_v] = ((lambda n, v=_v: effnet_leaves(v, n)),
                         (lambda p, x, cast=None, v=_v: effnet_forward(p, x, v, cast)))


def leaves_of(architecture: str, n_classes: int) -> List[Leaf]:
    return ARCHITECTURES[architecture][0](n_classes)


def forward_of(architecture: str):
    """fn(params, x, cast=None) -> logits."""
    return ARCHITECTURES[architecture][1]


def calibrate(architecture: str, p: Params, x: torch.Tensor) -> None:
    """Set every live BatchNorm's running statistics from batch ``x`` (no-op
    for an architecture without BatchNorm)."""
    if architecture.startswith("effb"):
        with torch.no_grad():
            effnet_forward(p, x, architecture, calibrate=True)
