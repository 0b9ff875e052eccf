"""The yardstick's arithmetic: the card's peaks, operation and byte counts,
the device's busy time from a trace, and the spread of a set of runs.

* Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W).
* FLOPs of a forward are counted by ``torch.utils.flop_counter`` over the
  reference's own forward on the meta device: shapes only, 2 per
  multiply-add, as ``chip_smoke.py`` ``family_gflop_per_page`` counts the
  program's modules.
* The vote's least bytes: per pixel of the padded batch, 1 bit of ink and 1
  byte of class read, 1 byte of voted class written.
* ``busy_us``: the union of the device intervals (``chip_smoke.py``
  ``profiled``), so overlapping copies and kernels count once.
"""
from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple

import torch

PEAK_FLOPS = {"bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
VOTE_BYTES_PER_PIXEL = 1 / 8 + 1 + 1


def forward_flops(architecture: str, n_classes: int, input_shape: Sequence[int]) -> float:
    """FLOPs of one forward of ``input_shape`` (N, C, H, W)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference import models

    with torch.device("meta"):
        params = {name: torch.empty(shape)
                  for name, shape, _ in models.leaves_of(architecture, n_classes)}
        x = torch.empty(tuple(input_shape))
    forward = models.forward_of(architecture)
    with FlopCounterMode(display=False) as counter:
        forward(params, x)
    return float(counter.get_total_flops())


def vote_bytes(n_pages: int, pad_shape: Sequence[int]) -> float:
    return n_pages * pad_shape[0] * pad_shape[1] * VOTE_BYTES_PER_PIXEL


def roofline_share(least_s: float, measured_s: float) -> float:
    """The least time over the measured time, in %."""
    return 100.0 * least_s / measured_s


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        total += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float) -> List[Tuple[float, float]]:
    """The gaps in [start, end] that no interval covers, as (start, end)."""
    gaps, reach = [], start
    for s, e in sorted(intervals):
        if s > reach:
            gaps.append((reach, min(s, end)))
        reach = max(reach, e)
        if reach >= end:
            break
    if reach < end:
        gaps.append((reach, end))
    return [g for g in gaps if g[1] > g[0]]


def spread(values: Sequence[float]) -> float:
    """(third quartile - first quartile) / median, as Python's
    ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
