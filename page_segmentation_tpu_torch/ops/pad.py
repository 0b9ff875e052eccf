"""Static-shape padding and bucketing.

Counterpart of ``page_segmentation_tpu/ops/pad.py``: pages are padded
bottom/right to a bucketed shape (a multiple of the encoder's stride) before
the forward, and the logits are cropped back exactly afterwards.
``bucket_report`` and ``suggest_granularity`` weigh the bucket sizes for a
distribution of page shapes.
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


def bucket_report(shapes: Sequence[Sequence[int]], factor: int = STRIDE_FACTOR,
                  granularities: Sequence[int] = (1, 2, 4, 8)) -> dict:
    """For each granularity: the number of distinct buckets ``shapes`` fall
    into, the padded pixels over the real ones less 1, and the share of the
    pages in the largest bucket.  Coarser buckets mean fewer shapes and
    more padding."""
    report = {}
    for granularity in granularities:
        buckets = {}
        real = padded = 0
        for shape in shapes:
            bucket = bucket_shape(shape, factor, granularity)
            buckets[bucket] = buckets.get(bucket, 0) + 1
            real += int(shape[0]) * int(shape[1])
            padded += bucket[0] * bucket[1]
        report[int(granularity)] = {
            "buckets": len(buckets),
            "padding_overhead": padded / real - 1.0 if real else 0.0,
            "largest_bucket_share": (max(buckets.values()) / len(shapes)) if shapes else 0.0,
        }
    return report


def suggest_granularity(shapes: Sequence[Sequence[int]], factor: int = STRIDE_FACTOR,
                        max_buckets: int = 8,
                        granularities: Sequence[int] = (1, 2, 4, 8, 16)) -> int:
    """The granularity of least padding among those with at most
    ``max_buckets`` buckets; the largest granularity if none has."""
    report = bucket_report(shapes, factor, granularities)
    eligible = [g for g, r in report.items() if r["buckets"] <= max_buckets]
    if not eligible:
        return max(report)
    return min(eligible, key=lambda g: report[g]["padding_overhead"])
