"""Foreground-pixel metrics and line-height estimation.

Counterpart of ``page_segmentation_tpu/evaluation/image_ops.py``: ``fgpa``,
``fgoverlap_per_class``, ``compute_char_height_arr`` (Otsu binarize,
4-connected components, letter-shaped boxes with 0.5 < w/h < 2, 10 < h < 60
and 5 < w < 50, then the upper median height, ``sorted[len // 2]``) and
``compute_char_height``, over the port's threshold and components.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..ops.cc import CC_STAT_HEIGHT, CC_STAT_WIDTH, connected_components_with_stats
from ..ops.threshold import otsu_binarize


def _fg_confusion(pred: np.ndarray, mask: np.ndarray, bin: np.ndarray, n_labels: int) -> np.ndarray:
    """(n_labels + 2)² confusion matrix over foreground pixels: row = mask
    label, column = predicted label, both offset by one so that row/column 0
    holds the pixels outside the foreground (``bin == 0``) and the last one
    the labels out of range (a mismatch for every tracked label)."""
    fg = bin.reshape(-1) != 0
    side = n_labels + 2

    def bucket(values):
        v = values.reshape(-1).astype(np.int64)
        slot = np.where((v < 0) | (v >= n_labels), side - 1, v + 1)
        return np.where(fg, slot, 0)

    return np.bincount(bucket(mask) * side + bucket(pred), minlength=side * side).reshape(side, side)


def fgpa(pred: np.ndarray, mask: np.ndarray, bin: np.ndarray) -> float:
    """Foreground pixel accuracy: the share of foreground pixels (nonzero in
    ``bin``) whose predicted label equals the mask's; 0 without foreground."""
    fg = bin != 0
    return np.count_nonzero(fg & (pred == mask)) / max(np.count_nonzero(fg), 1)


def fgoverlap_per_class(
    pred: np.ndarray, mask: np.ndarray, bin: np.ndarray, n_classes: int
) -> Tuple[List[float], List[int], List[int], List[int]]:
    """Per-label foreground overlap (IoU), tp, fp and fn: four lists of
    length ``n_classes + 1`` indexed by label value (0 = not classified);
    a label with no pixels of interest has overlap ``nan``."""
    n_labels = n_classes + 1
    conf = _fg_confusion(pred, mask, bin, n_labels)
    labels = slice(1, n_labels + 1)
    tp = np.diagonal(conf)[labels]
    fp = conf[1:, labels].sum(axis=0) - tp
    fn = conf[labels, 1:].sum(axis=1) - tp
    interest = tp + fp + fn
    with np.errstate(invalid="ignore"):
        overlap = np.where(interest > 0, tp / np.maximum(interest, 1), np.nan)
    return overlap.tolist(), tp.tolist(), fp.tolist(), fn.tolist()


def compute_char_height_arr(img: np.ndarray, inverse: bool) -> Optional[int]:
    """Median letter height of a grayscale page, None without letters."""
    _, _, stats, _ = connected_components_with_stats(otsu_binarize(img, invert=inverse), connectivity=4)
    widths = stats[1:, CC_STAT_WIDTH].astype(np.float64)
    heights = stats[1:, CC_STAT_HEIGHT].astype(np.float64)
    ratio = widths / np.maximum(heights, 1e-9)
    letterish = ((0.5 < ratio) & (ratio < 2) & (10 < heights) & (heights < 60)
                 & (5 < widths) & (widths < 50))
    valid_heights = np.sort(stats[1:, CC_STAT_HEIGHT][letterish])
    if len(valid_heights) == 0:
        return None
    return int(valid_heights[len(valid_heights) // 2])


def compute_char_height(file_name: str, inverse: bool) -> Optional[int]:
    if not os.path.exists(file_name):
        raise FileNotFoundError(f"File does not exist at {file_name}")
    from ..core.image_io import imread

    return compute_char_height_arr(imread(file_name, as_gray=True), inverse)
