"""Static-shape padding and bucketing.

Counterpart of ``page_segmentation_tpu/ops/pad.py``: pages are padded
bottom/right to a bucketed shape (a multiple of the encoder's stride) before
the forward, and the logits are cropped back exactly afterwards.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

STRIDE_FACTOR = 32  # product of the encoder's pooling strides (2^5 covers all archs)


def padding_for(shape: Sequence[int], factor: int = STRIDE_FACTOR) -> Tuple[int, int]:
    """(pad_h, pad_w) to the next multiple of ``factor``."""
    h, w = int(shape[0]), int(shape[1])
    return (factor - h % factor) % factor, (factor - w % factor) % factor


def round_up(value: int, factor: int) -> int:
    return -(-int(value) // factor) * factor


def bucket_shape(shape: Sequence[int], factor: int = STRIDE_FACTOR,
                 granularity: int = 1) -> Tuple[int, int]:
    """Bucketed target shape: a multiple of ``factor * granularity``."""
    step = factor * granularity
    return round_up(shape[0], step), round_up(shape[1], step)


def pad_to(image: np.ndarray, target: Sequence[int], value=0) -> np.ndarray:
    """Pad bottom/right to ``target`` (H, W) with ``value``; channels untouched."""
    th, tw = int(target[0]), int(target[1])
    h, w = image.shape[:2]
    if (h, w) == (th, tw):
        return image
    pad_width = [(0, th - h), (0, tw - w)] + [(0, 0)] * (image.ndim - 2)
    return np.pad(image, pad_width, mode="constant", constant_values=value)


def crop_to(array: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """The top-left (H, W) region: the inverse of :func:`pad_to`."""
    return array[: int(shape[0]), : int(shape[1])]
