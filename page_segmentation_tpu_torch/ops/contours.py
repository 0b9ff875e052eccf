"""External contours of binary regions, and their filled polygons.

Counterpart of the JAX package's ``ops.contours``, the part of
cv2.findContours / cv2.drawContours that the segmentation uses: external
contours (8-connectivity) as (N, 2) int32 (x, y) point arrays in raster
discovery order, collinear runs compressed to their end points.  The
native Moore tracer (``native.contours``) is the path; the scipy-labeled
Python tracer :func:`find_external_contours_plain` is its plain version.
``fill_contour`` fills with the port's rasterizer (PIL's polygon fill),
which equals cv2.drawContours(..., FILLED) on boundary-traced polygons.
"""
from __future__ import annotations

from typing import List

import numpy as np

from .. import native

# Moore neighborhood, clockwise from west, as (dy, dx)
_NEIGHBORS = [(0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1)]


def _trace_boundary(mask: np.ndarray, start: tuple) -> List[tuple]:
    """Moore-neighbor trace of the component whose topmost-leftmost pixel is
    ``start``; [(y, x), ...].  Ends by Jacob's criterion: when the walk is
    about to repeat its first move (a boundary may pass its start twice)."""
    h, w = mask.shape

    def next_from(current, backtrack):
        for k in range(8):
            d = (backtrack + 1 + k) % 8
            dy, dx = _NEIGHBORS[d]
            ny, nx = current[0] + dy, current[1] + dx
            if 0 <= ny < h and 0 <= nx < w and mask[ny, nx]:
                return (ny, nx), d
        return None, None

    second, first_dir = next_from(start, 0)  # west of start is background
    if second is None:
        return [start]
    boundary = [start]
    current, backtrack = second, (first_dir + 4) % 8
    for _ in range(4 * mask.size):
        boundary.append(current)
        nxt, d = next_from(current, backtrack)
        if nxt == start:
            after, after_dir = next_from(start, (d + 4) % 8)
            if (after, after_dir) == (second, first_dir):
                return boundary
        current, backtrack = nxt, (d + 4) % 8
    return boundary


def _simplify(points: List[tuple]) -> np.ndarray:
    """Collinear runs (horizontal, vertical, diagonal) to their end points."""
    if len(points) <= 2:
        return np.array(points, dtype=np.int32)
    out = [points[0]]
    for i in range(1, len(points) - 1):
        dy0, dx0 = points[i][0] - out[-1][0], points[i][1] - out[-1][1]
        dy1, dx1 = points[i + 1][0] - points[i][0], points[i + 1][1] - points[i][1]
        norm0 = max(abs(dy0), abs(dx0)) or 1
        norm1 = max(abs(dy1), abs(dx1)) or 1
        if (dy0 * norm1, dx0 * norm1) != (dy1 * norm0, dx1 * norm0):
            out.append(points[i])
    out.append(points[-1])
    return np.array(out, dtype=np.int32)


def find_external_contours_plain(binary: np.ndarray) -> List[np.ndarray]:
    """:func:`find_external_contours` by scipy labeling and the Python
    tracer: the plain version of the native tracer."""
    from scipy import ndimage as ndi

    mask = np.asarray(binary) != 0
    labels, num = ndi.label(mask, structure=np.ones((3, 3), bool))
    contours = []
    # scipy numbers components in raster order, the discovery order
    for i, slc in enumerate(ndi.find_objects(labels), start=1):
        if slc is None:
            continue
        component = labels[slc] == i
        ys, xs = np.nonzero(component)
        first = np.argmin(ys * component.shape[1] + xs)
        pts = _simplify(_trace_boundary(component, (int(ys[first]), int(xs[first]))))
        contours.append(np.stack([pts[:, 1] + slc[1].start, pts[:, 0] + slc[0].start],
                                 axis=1).astype(np.int32))
    return contours


def find_external_contours(binary: np.ndarray) -> List[np.ndarray]:
    """External contours of each 8-connected component of the nonzero
    pixels: (N, 2) int32 (x, y) arrays, in raster discovery order."""
    return native.contours(binary)


def fill_contour(canvas: np.ndarray, contour: np.ndarray, value) -> None:
    """Fill the polygon of (x, y) points into ``canvas`` in place, as
    cv2.drawContours(..., FILLED) does for boundary-traced polygons; fewer
    than three points set their own pixels."""
    contour = np.asarray(contour)
    if contour.ndim != 2 or contour.shape[0] < 3:
        if contour.ndim == 2:
            for x, y in contour:
                canvas[int(y), int(x)] = value
        return
    if canvas.dtype == np.uint8 and canvas.flags.c_contiguous and canvas.ndim in (2, 3):
        native.fill_polygon(canvas, contour, value)
        return
    mask = np.zeros(canvas.shape[:2], np.uint8)
    native.fill_polygon(mask, contour, 1)
    canvas[mask.view(bool)] = value
