"""Recursive XY-cut page segmentation.

Counterpart of the JAX package's ``segmentation.xycut``: the region classes
(``CVContour``, ``RectSegment``), ``ProfileTables`` and ``do_xy_cut``.  Two
prefix-sum tables of a page's foreground make the projection profile of any
subregion a difference of two table rows or columns, so the cut never
rescans pixels; subregions are processed depth-first from an explicit
stack.  ``profile_tables_batch`` builds the tables of a batch of pages with
one torch ``cumsum`` per axis on the requested device.

The cut keeps three quirks of the reference, on which its outputs depend:
the end sentinel of a segment list is ``shape[axis]`` even where the profile
runs over the other axis, leaf rectangles put the profile axis's extent on
the row ("x") coordinate, and a zero-sized child window ends the remaining
siblings of its level.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import List, Optional, Tuple, TypeVar, Union

import numpy as np

RGBColor = Tuple[int, int, int]


class Region(ABC):
    @abstractmethod
    def polygon_coords(self) -> Union[List[Tuple[int, int]], np.ndarray]:
        ...

    @abstractmethod
    def scale(self, factor: float) -> "Region":
        ...


@dataclass
class CVContour(Region):
    """A polygonal region as an (N, 2) point array."""

    contour: np.ndarray

    def __post_init__(self):
        self.contour = np.squeeze(self.contour)

    def polygon_coords(self) -> Union[List[Tuple[int, int]], np.ndarray]:
        return np.squeeze(self.contour)

    def scale(self, factor: float) -> "CVContour":
        return CVContour((self.contour * factor).astype("int32"))


@dataclass
class RectSegment(Region):
    """An axis-aligned rectangle; x indexes rows, y indexes columns (the
    reference's convention)."""

    x_start: int
    y_start: int
    x_end: int
    y_end: int

    def scale(self, factor: float) -> "RectSegment":
        return RectSegment(
            x_start=int(self.x_start * factor),
            y_start=int(self.y_start * factor),
            x_end=int(self.x_end * factor),
            y_end=int(self.y_end * factor),
        )

    def polygon_coords(self) -> Union[List[Tuple[int, int]], np.ndarray]:
        return [
            (self.x_start, self.y_start),
            (self.x_end, self.y_start),
            (self.x_end, self.y_end),
            (self.x_start, self.y_end),
        ]


AnyRegion = TypeVar("AnyRegion", Region, RectSegment, CVContour)


@dataclass
class Segment1D:
    start: int
    end: int

    def __len__(self):
        return self.end - self.start


@dataclass
class Gap:
    start: int
    length: int


class ProfileTables:
    """Prefix sums of a page's foreground indicator.

    ``down[r, c]``  = number of foreground pixels in rows [0, r) of column c
    ``right[r, c]`` = number of foreground pixels in cols [0, c) of row r

    ``profile`` answers "how many foreground pixels does each line of a
    subregion hold" in O(extent) regardless of the subregion's area.
    """

    def __init__(self, down: np.ndarray, right: np.ndarray):
        self.down = down
        self.right = right

    @classmethod
    def of_image(cls, binary_image: np.ndarray) -> "ProfileTables":
        fg = np.asarray(binary_image) != 0
        h, w = fg.shape
        down = np.zeros((h + 1, w), np.int32)
        np.cumsum(fg, axis=0, out=down[1:])
        right = np.zeros((h, w + 1), np.int32)
        np.cumsum(fg, axis=1, out=right[:, 1:])
        return cls(down, right)

    def profile(self, rows: Segment1D, cols: Segment1D, axis: int) -> np.ndarray:
        """Foreground count per column (axis=0) or per row (axis=1) of the
        subregion ``rows × cols``."""
        if axis == 0:
            return self.down[rows.end, cols.start : cols.end] - self.down[rows.start, cols.start : cols.end]
        return self.right[rows.start : rows.end, cols.end] - self.right[rows.start : rows.end, cols.start]


def _get_gaps(indication: np.ndarray) -> List[Gap]:
    """Maximal runs of False in a boolean vector, as (start, length) gaps."""
    padded = np.concatenate(([True], np.asarray(indication, bool), [True]))
    edges = np.flatnonzero(np.diff(padded))
    starts, ends = edges[0::2], edges[1::2]
    return [Gap(start=int(s), length=int(e - s)) for s, e in zip(starts, ends)]


def _get_segments(gaps: List[Gap], length: int, px_threshold, split_size) -> List[Segment1D]:
    """Intervals between significant gaps.

    Gaps shorter than ``split_size`` are not worth cutting at; the spans
    between the surviving gaps (bracketed by virtual gaps at 0 and
    ``length``) become segments when wider than ``px_threshold``.
    """
    cut_ends = [g.start + g.length for g in gaps if g.length >= split_size]
    cut_starts = [g.start for g in gaps if g.length >= split_size]
    span_starts = np.array([0] + cut_ends)
    span_ends = np.array(cut_starts + [length])
    wide = span_ends - span_starts > px_threshold
    return [Segment1D(int(s), int(e)) for s, e, keep in zip(span_starts, span_ends, wide) if keep]


def do_xy_cut(
    binary_image: np.ndarray,
    px_threshold_line: int,
    px_threshold_column: int,
    split_size_horizontal: int,
    split_size_vertical: int,
    tables: Optional[ProfileTables] = None,
) -> List[RectSegment]:
    """Recursive XY cut into rectangular regions.

    :param binary_image: boolean/0-1 array, truthy is foreground
    :param px_threshold_line: minimum height to further split horizontally
    :param px_threshold_column: minimum width to further split vertically
    :param split_size_horizontal: free-space pixels for a horizontal cut
    :param split_size_vertical: free-space pixels for a vertical cut
    :param tables: optional precomputed profile tables (e.g. produced on
        device for a batch of pages); derived from the image when absent
    """
    binary_image = np.asarray(binary_image)
    if tables is None:
        tables = ProfileTables.of_image(binary_image)
    thresholds = (px_threshold_line, px_threshold_column)
    min_gap = (split_size_horizontal, split_size_vertical)

    out: List[RectSegment] = []
    # depth-first worklist of absolute subregions; `final` marks nodes whose
    # 1-D segments are emitted directly (parent produced a single segment)
    stack: List[Tuple[Segment1D, Segment1D, int, bool]] = [
        (Segment1D(0, binary_image.shape[0]), Segment1D(0, binary_image.shape[1]), 0, False)
    ]
    while stack:
        rows, cols, axis, final = stack.pop()
        extent = (len(rows), len(cols))
        occupied = tables.profile(rows, cols, axis) >= thresholds[axis]
        gaps = _get_gaps(occupied)

        # leaf: no free space at all — emit the whole subregion, with the
        # profile-axis extent on the row coordinate (reference quirk)
        if not gaps:
            out.append(
                RectSegment(
                    x_start=rows.start,
                    x_end=rows.start + extent[axis],
                    y_start=cols.start,
                    y_end=cols.start + extent[1],
                )
            )
            continue

        segments = _get_segments(gaps, extent[axis], thresholds[axis], min_gap[axis])

        if final:
            out.extend(
                RectSegment(
                    x_start=rows.start + s.start,
                    x_end=rows.start + s.end,
                    y_start=cols.start,
                    y_end=cols.start + extent[1],
                )
                for s in segments
            )
            continue

        children = []
        for s in segments:
            if len(s) <= thresholds[axis]:
                continue
            # the quirky shape[axis] sentinel can push a segment past the
            # subregion; clamp like the reference's implicit numpy slicing
            if axis == 0:  # column profile → vertical cut
                lo = cols.start + min(s.start, extent[1])
                hi = cols.start + min(s.end, extent[1])
                child = (rows, Segment1D(lo, hi))
            else:  # row profile → horizontal cut
                lo = rows.start + min(s.start, extent[0])
                hi = rows.start + min(s.end, extent[0])
                child = (Segment1D(lo, hi), cols)
            if len(child[0]) == 0 or len(child[1]) == 0:
                break  # reference quirk: abort remaining siblings
            children.append((child[0], child[1], 1 - axis, len(segments) == 1))
        stack.extend(reversed(children))  # preserve depth-first output order
    return out


def profile_tables_batch(binary_images, device="cuda") -> List[ProfileTables]:
    """Profile tables of a batch of same-shaped pages, the two prefix sums
    computed on ``device``; the (small) cut recursion stays on the host."""
    import torch

    from ..device import resolve_device

    fg = torch.from_numpy(np.ascontiguousarray(np.asarray(binary_images) != 0))
    fg = fg.to(resolve_device(device)).to(torch.int32)
    down = torch.cumsum(fg, dim=1, dtype=torch.int32).cpu().numpy()
    right = torch.cumsum(fg, dim=2, dtype=torch.int32).cpu().numpy()
    n, h, w = fg.shape
    tables = []
    for i in range(n):
        d = np.zeros((h + 1, w), np.int32)
        d[1:] = down[i]
        r = np.zeros((h, w + 1), np.int32)
        r[:, 1:] = right[i]
        tables.append(ProfileTables(d, r))
    return tables
