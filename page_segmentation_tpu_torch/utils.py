"""Shape plumbing helpers.

Counterpart of ``page_segmentation_tpu/utils.py``: channel expansion to
RGB, batching a single page, and a value-preserving (nearest-neighbour)
resize built on the port's resize op.
"""
from __future__ import annotations

import numpy as np

from .ops.resize import resize_nearest


def gray_to_rgb(img: np.ndarray) -> np.ndarray:
    """An ``(..., 3)`` array for any gray input: a trailing 3-channel axis
    passes through, a trailing single channel is repeated, and anything
    else gains a last axis of three identical channels."""
    if img.ndim == 3 and img.shape[-1] == 3:
        return img
    if img.ndim == 3 and img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)  # (H, W, 1) -> (H, W, 3), not rank 4
    return np.repeat(img[..., None], 3, axis=-1)


def image_to_batch(img: np.ndarray) -> np.ndarray:
    """One page as a batch-of-one NHWC array: a 2-D ``(H, W)`` page gains
    the batch and the channel axis, one with channels only the batch axis."""
    want_channel = (1,) if img.ndim == 2 else ()
    return img.reshape((1,) + img.shape + want_channel)


def preserving_resize(image: np.ndarray, target_shape) -> np.ndarray:
    """Resize preserving values (no anti-aliasing, no range change)."""
    return resize_nearest(image, target_shape)
