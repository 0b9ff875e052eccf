"""Binarization: a copy of ``page_segmentation_tpu/ops/threshold.py``
``otsu_threshold`` and ``otsu_binarize`` (cv2's THRESH_BINARY + THRESH_OTSU
convention) and ``binarize_into``."""
from __future__ import annotations

import numpy as np


def otsu_threshold(gray: np.ndarray) -> int:
    """The Otsu threshold of a uint8 image: the t that maximizes the
    between-class variance of pixels <= t against pixels > t."""
    gray = np.asarray(gray, dtype=np.uint8)
    hist = np.bincount(gray.ravel(), minlength=256).astype(np.float64)
    total = hist.sum()
    if total == 0:
        return 0
    weight0 = np.cumsum(hist)
    weight1 = total - weight0
    cum_mean = np.cumsum(hist * np.arange(256, dtype=np.float64))
    with np.errstate(divide="ignore", invalid="ignore"):
        mean0 = cum_mean / weight0
        mean1 = (cum_mean[-1] - cum_mean) / weight1
        between = weight0 * weight1 * (mean0 - mean1) ** 2
    return int(np.argmax(np.nan_to_num(between, nan=-1.0)))


def otsu_binarize(gray: np.ndarray, invert: bool = False) -> np.ndarray:
    """0/255 uint8: pixels strictly above the threshold become 255, then,
    unless ``invert``, the result is subtracted from 255."""
    binary = np.where(np.asarray(gray) > otsu_threshold(gray), np.uint8(255), np.uint8(0))
    return binary if invert else (255 - binary).astype(np.uint8)


def binarize_into(gray: np.ndarray, out: np.ndarray, threshold: int = 128) -> np.ndarray:
    """Write ``gray >= threshold -> 255 else 0`` into the uint8 ``out`` without
    temporaries (``imread_bin``'s rule); the raw corpus binarizes decoded
    pages straight into its reusable buffers.  ``threshold =
    otsu_threshold(gray) + 1`` is the Otsu convention (pixels strictly above
    the threshold become 255)."""
    if out.dtype != np.uint8 or out.shape != gray.shape:
        raise ValueError(f"out must be uint8 of shape {gray.shape}")
    if out.flags.c_contiguous:
        np.greater_equal(gray, threshold, out=out.view(np.bool_))
        np.multiply(out, 255, out=out)
    else:
        out[...] = np.where(gray >= threshold, np.uint8(255), np.uint8(0))
    return out
