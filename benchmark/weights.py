"""Seeded weights for a list of leaves, made on the device in one draw.

One ``torch.Generator`` on the device, seeded from ``--seed``, draws every
standard normal of the model in a single call; each leaf is a slice of that
draw scaled by its kind: ``he`` (std sqrt(2 / fan_in), before a ReLU),
``lecun`` (std 1 / sqrt(fan_in)), with ``_tS`` for a transposed
convolution (in, out, kh, kw) of stride S, whose fan-in is in*kh*kw / S^2;
``bias`` 0.1 N(0, 1); ``bn_scale`` 1 + 0.1 N(0, 1); ``bn_mean`` 0 and
``bn_var`` 1 until a calibration sets them.  The same dict goes to the
program and to the reference.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference.models import Leaf


def _std(shape, kind: str) -> float:
    base, _, transposed = kind.partition("_t")
    if transposed:
        fan_in = shape[0] * shape[2] * shape[3] / int(transposed) ** 2
    else:
        fan_in = math.prod(shape[1:])
    return math.sqrt((2.0 if base == "he" else 1.0) / fan_in)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 64))
    return g


def make_weights(leaves: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    draw = torch.randn(total, generator=generator(seed, device), device=device,
                       dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in leaves:
        n = math.prod(shape)
        z = draw[at:at + n].view(shape)
        at += n
        if kind == "bias":
            out[name] = z * 0.1
        elif kind == "bn_scale":
            out[name] = 1.0 + 0.1 * z
        elif kind == "bn_mean":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "bn_var":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = z * _std(shape, kind)
    return out
