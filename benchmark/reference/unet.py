"""A frozen plain-PyTorch U-Net, as the benchmark's training reference runs it.

U-Net (Ronneberger, Fischer and Brox, arXiv:1505.04597) as
ocr4all_pixel_classifier 0.6.5 builds it (``lib/model.py:151`` ``unet``):
two 3x3 convolutions with ReLU at each of the widths 64/128/256/512/1024,
2x2 max pools between them, dropout 0.5 on the outputs of the two deepest
blocks, then four steps up, each a 2x upsampling, a 2x2 convolution with
ReLU to half the width, the concatenation ``[skip, up]`` and two 3x3
convolutions, and 1x1 logits.  It departs from the paper where the
reference code does:

* every convolution and pool pads as TensorFlow's SAME (the odd pixel
  after), so the page keeps its size; the paper's convolutions are unpadded
  and crop the skips;
* the way up is a nearest-neighbour 2x upsampling followed by a 2x2
  convolution (Keras ``UpSampling2D`` + ``Conv2D``), not a transposed
  convolution;
* the paper's dropout sits only at the end of the contracting path; the
  reference code drops after both of the two deepest blocks.

Leaves are (name, shape, kind) under the ``state_dict`` names of the
program's module, so one dict of weights serves both.  The forward takes
``drop(h, i)``, the dropout of the i-th dropout layer (0: after the
512-wide block, 1: after the 1024-wide block), or None for none.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
import torch.nn.functional as F

from .models import Leaf, Params, conv, max_pool_same

WIDTHS = (64, 128, 256, 512, 1024)
# (channels, stride) of each dropout's input, in the order the forward meets them
DROPOUTS = ((512, 8), (1024, 16))


def unet_leaves(n_classes: int = 3, in_channels: int = 1) -> List[Leaf]:
    leaves: List[Leaf] = []

    def add(name, cin, cout, k, kind="he"):
        leaves.extend([(f"{name}.weight", (cout, cin, k, k), kind), (f"{name}.bias", (cout,), "bias")])

    cin = in_channels
    for i, width in enumerate(WIDTHS, start=1):
        add(f"conv{i}a", cin, width, 3)
        add(f"conv{i}b", width, width, 3)
        cin = width
    for i, width in zip(range(6, 10), reversed(WIDTHS[:-1])):
        add(f"up{i}", 2 * width, width, 2)
        add(f"conv{i}a", 2 * width, width, 3)
        add(f"conv{i}b", width, width, 3)
    add("logits", WIDTHS[0], n_classes, 1, "lecun")
    return leaves


def unet_forward(p: Params, x: torch.Tensor,
                 drop: Optional[Callable[[torch.Tensor, int], torch.Tensor]] = None) -> torch.Tensor:
    """(N, 1, H, W) float32, H and W multiples of 16 -> (N, C, H, W) logits."""
    def c(name, h):
        return F.relu(conv(h, p[f"{name}.weight"], p[f"{name}.bias"]))

    def double(name, h):
        return c(f"{name}b", c(f"{name}a", h))

    def dropped(h, i):
        return h if drop is None else drop(h, i)

    conv1 = double("conv1", x)
    conv2 = double("conv2", max_pool_same(conv1))
    conv3 = double("conv3", max_pool_same(conv2))
    drop4 = dropped(double("conv4", max_pool_same(conv3)), 0)
    h = dropped(double("conv5", max_pool_same(drop4)), 1)
    for i, skip in zip(range(6, 10), (drop4, conv3, conv2, conv1)):
        up = c(f"up{i}", F.interpolate(h, scale_factor=2, mode="nearest"))
        h = double(f"conv{i}", torch.cat([skip, up], 1))
    return conv(h, p["logits.weight"], p["logits.bias"], padding="VALID")
