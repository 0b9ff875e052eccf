"""Offline evaluation metrics.

Counterpart of ``page_segmentation_tpu/evaluation/metrics.py``:
``count_matches`` (with the reference's behaviour, where fp counts
mask-and-not-pred pixels and fn pred-and-not-mask ones), ``total_accuracy``,
``f1``, ``f1_measures``, ``cc_equal``, ``cc_matching`` and
``ConnectedComponentEval`` over the port's connected components.
"""
from __future__ import annotations

from typing import Callable, Generator, Iterator, Tuple, TypeVar

import numpy as np

from ..ops.cc import cc_window, connected_components_with_stats

T = TypeVar("T")


def count_matches(mask: np.ndarray, pred: np.ndarray, label: int) -> Tuple[int, int, int]:
    """(tp, fp, fn) of one label, from one pass over the code
    ``2 * [mask == label] + [pred == label]``: 3 = tp, 2 = fp, 1 = fn."""
    code = 2 * (mask == label).astype(np.int8) + (pred == label).astype(np.int8)
    counts = np.bincount(code.reshape(-1), minlength=4)
    return int(counts[3]), int(counts[2]), int(counts[1])


def total_accuracy(mask: np.ndarray, pred: np.ndarray) -> Tuple[int, int]:
    """(correct, total) pixel counts over all classes."""
    return mask.size - np.count_nonzero(mask != pred), mask.size


def f1(precision: float, recall: float) -> float:
    return 2 * precision * recall / (precision + recall)


def f1_measures(tp: int, fp: int, fn: int) -> Tuple[float, float, float]:
    """(precision, recall, f1); all zero without true positives."""
    if tp == 0:
        return 0.0, 0.0, 0.0
    precision, recall = tp / (tp + fp), tp / (tp + fn)
    return precision, recall, f1(precision, recall)


def _coverage(values: np.ndarray, label: int) -> float:
    return np.count_nonzero(values == label) / values.size


def cc_equal(threshold: float) -> Callable[[np.ndarray, np.ndarray], bool]:
    """Component matcher: true when at least ``threshold`` of the pixels agree."""

    def agree(pred: np.ndarray, mask: np.ndarray) -> bool:
        return 1.0 - np.count_nonzero(pred != mask) / mask.size >= threshold

    return agree


def cc_matching(label: int, threshold_tp: float, threshold_fp: float, threshold_mask: float = None):
    """Per-component matcher giving a ``[tp, fp, fn]`` indicator array: a
    component is predicted when its ``label`` coverage in the prediction
    reaches ``threshold_tp`` (``threshold_fp`` for false positives), and
    expected when the mask's reaches ``threshold_mask`` (default
    ``threshold_tp``)."""
    threshold_mask = threshold_mask or threshold_tp

    def match(mask: np.ndarray, pred: np.ndarray) -> np.ndarray:
        pred_cov = _coverage(pred, label)
        expected = _coverage(mask, label) >= threshold_mask
        predicted = pred_cov >= threshold_tp
        return np.array([int(predicted and expected),
                         int(pred_cov >= threshold_fp and not expected),
                         int(expected and not predicted)])

    return match


class ConnectedComponentEval:
    """A metric evaluated on each connected component of a binary page;
    ``only_label`` keeps the components that carry the label in the mask (at
    least ``threshold`` coverage) or anywhere in the prediction."""

    def __init__(self, mask: np.ndarray, prediction: np.ndarray, binary_image: np.ndarray,
                 connectivity: int = 4):
        if binary_image.ndim > 2:
            raise ValueError("Binary image must be 2-dimensional")
        self.mask = mask
        self.pred = prediction
        self.binary_image = binary_image
        self.filtered_label = None
        self.threshold = None
        self.num_labels, self.labels, self.stats, self.centroids = connected_components_with_stats(
            binary_image.astype("uint8"), connectivity=connectivity)

    def only_label(self, label: int, threshold: float) -> "ConnectedComponentEval":
        self.filtered_label = label
        self.threshold = threshold
        return self

    def _component_pixels(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """(mask pixels, pred pixels) of each component."""
        for i in range(1, self.num_labels):
            window = cc_window(self.stats, i)
            inside = self.labels[window] == i
            yield self.mask[window][inside], self.pred[window][inside]

    def _keep(self, mask_px: np.ndarray, pred_px: np.ndarray) -> bool:
        if self.filtered_label is None:  # label 0 is a real filter
            return True
        return (_coverage(mask_px, self.filtered_label) >= self.threshold
                or _coverage(pred_px, self.filtered_label) > 0)

    def run_per_component(self, func: Callable[[np.ndarray, np.ndarray], T]) -> Generator[T, None, None]:
        return (func(mask_px, pred_px) for mask_px, pred_px in self._component_pixels()
                if self._keep(mask_px, pred_px))
