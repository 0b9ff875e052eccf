"""The training cells' arithmetic: the card's TF32 peak, the FLOPs of one
step's forward and backward, and the bytes the dropout kernel moves.

* TF32 peak of one NVIDIA H100 SXM, dense, at 700 W (NVIDIA's data sheet):
  494.7 TFLOP/s.  The train path runs its convolutions in TF32, cuDNN's
  default.
* FLOPs of a step are counted by ``torch.utils.flop_counter`` over the
  reference's own forward, loss and autograd backward on the meta device at
  the padded batch shape: shapes only, 2 per multiply-add.  The input needs
  no gradient, so the first convolution's backward counts its weight's
  gradient alone.  The optimizer's elementwise work counts nothing.
* The dropout's bytes: each pass (forward on x, backward on dy) reads and
  writes its tensor once, float32: ``2 * 4`` bytes an element a pass, two
  passes, over each dropout's input (N, C, ceil(H / s), ceil(W / s)).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

TF32_PEAK_FLOPS = 494.7e12


def step_flops(architecture: str, n_classes: int, input_shape: Sequence[int]) -> float:
    """FLOPs of one forward and backward of ``input_shape`` (N, C, H, W)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import train as ref

    with torch.device("meta"):
        params = {name: torch.empty(shape, requires_grad=True)
                  for name, shape, _ in ref.leaves_of(architecture, n_classes)}
        x = torch.empty(tuple(input_shape))
        labels = torch.zeros((input_shape[0],) + tuple(input_shape[2:]), dtype=torch.int64)
        weights = torch.ones((input_shape[0],) + tuple(input_shape[2:]))
    with FlopCounterMode(display=False) as counter:
        loss = ref.loss_of(ref.forward_of(architecture)(params, x), labels, weights)
        torch.autograd.grad(loss, list(params.values()))
    return float(counter.get_total_flops())


def dropout_bytes(architecture: str, batch: int, pad_shape: Sequence[int],
                  itemsize: int = 4) -> int:
    """Bytes the dropout kernel reads and writes in one step, forward and
    backward (0 for a model without dropout)."""
    if architecture != "unet":
        return 0
    from .reference.unet import DROPOUTS

    h, w = pad_shape
    total = 0
    for channels, stride in DROPOUTS:
        total += batch * channels * math.ceil(h / stride) * math.ceil(w / stride)
    return 2 * 2 * itemsize * total
