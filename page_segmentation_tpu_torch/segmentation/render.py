"""Region renders of the segmentation (the ``page-segmentation`` images).

Counterpart of the JAX package's ``segmentation.render``.  Rectangles are
inclusive slice fills and polygons go through ``ops.contours.fill_contour``.
The command's renders are palette-index canvases (:class:`PaletteImage`)
written as indexed PNGs by ``core.image_io.imsave_indexed``; a decoder
recovers the same RGB pixels as from the JAX package's files.
``render_rect_segments`` and ``render_contours`` (alias
``render_ocv_contours``) paint RGB canvases, returned as (H, W, 3) arrays
where the JAX package returns PIL images of the same pixels.

Coordinate quirks kept from the reference: ``render_xycut`` reverses
``orig_shape`` into a (width, height) canvas size while
``render_morphological`` takes it as it is, and rectangle fills include
both end points.
"""
from __future__ import annotations

import os
from typing import Callable, List, NamedTuple, Sequence, Tuple, Union

import numpy as np

from ..core.colors import ColorMap
from ..core.image_io import imsave, imsave_indexed, split_filename
from ..ops.contours import fill_contour
from .xycut import AnyRegion, CVContour, RectSegment, RGBColor

WHITE: RGBColor = (255, 255, 255)


class PaletteImage(NamedTuple):
    """An (H, W) uint8 index canvas and its (n, 3) uint8 palette."""

    indices: np.ndarray
    palette: np.ndarray

    def to_rgb(self) -> np.ndarray:
        return self.palette[self.indices]


def _index_canvas(size: Tuple[int, int]) -> np.ndarray:
    width, height = size
    return np.zeros((height, width), np.uint8)


def _paint_rects(canvas: np.ndarray, rects: Sequence[RectSegment], fill) -> None:
    """Fill rectangles in place, end points included; x indexes rows and y
    columns.  A rectangle wholly before the canvas paints nothing (a
    negative end would wrap into a from-the-end slice)."""
    fill = np.asarray(fill, canvas.dtype)
    for r in rects:
        if r.x_end < 0 or r.y_end < 0:
            continue
        canvas[max(r.x_start, 0) : r.x_end + 1, max(r.y_start, 0) : r.y_end + 1] = fill


def _paint_contours(canvas: np.ndarray, contours: Sequence[CVContour], fill) -> None:
    fill = np.asarray(fill, canvas.dtype)
    for contour in contours:
        fill_contour(canvas, np.atleast_2d(contour.contour), fill)


def render_rect_segments(size: Tuple[int, int],
                         segment_groups: List[Tuple[RGBColor, List[RectSegment]]],
                         base_color: RGBColor = WHITE) -> np.ndarray:
    """An (H, W, 3) uint8 canvas of the (width, height) ``size`` in
    ``base_color``, each group's rectangles filled with its color in turn."""
    width, height = size
    canvas = np.broadcast_to(np.asarray(base_color, np.uint8), (height, width, 3)).copy()
    for color, segments in segment_groups:
        _paint_rects(canvas, segments, color)
    return canvas


def render_contours(base_image, contours: List[CVContour], color_rgb: RGBColor) -> np.ndarray:
    """A copy of ``base_image`` (an array, or anything ``np.array`` takes)
    with ``contours`` filled in ``color_rgb``."""
    canvas = np.array(base_image)
    _paint_contours(canvas, contours, color_rgb)
    return canvas


def render_xycut(orig_shape: Tuple[int, int], label_colors: ColorMap,
                 segments_text: List[RectSegment],
                 segments_image: List[RectSegment]) -> PaletteImage:
    indices = _index_canvas(tuple(reversed(orig_shape)))
    palette = [WHITE, label_colors.color_for_label("text"), label_colors.color_for_label("image")]
    _paint_rects(indices, segments_text, 1)
    _paint_rects(indices, segments_image, 2)
    return PaletteImage(indices, np.asarray(palette, np.uint8))


def render_morphological(orig_shape: Tuple[int, int], label_colors: ColorMap,
                         segments_text: List[CVContour],
                         segments_image: List[RectSegment]) -> PaletteImage:
    indices = _index_canvas(orig_shape)
    palette = [WHITE, label_colors.color_for_label("image"), label_colors.color_for_label("text")]
    _paint_rects(indices, segments_image, 1)
    _paint_contours(indices, segments_text, 2)
    return PaletteImage(indices, np.asarray(palette, np.uint8))


def render_regions(
    output_dir: str,
    extension: str,
    orig_shape: Tuple[int, int],
    prediction_path: str,
    label_colors: ColorMap,
    method: Callable[[Tuple[int, int], ColorMap, List[AnyRegion], List[AnyRegion]],
                     Union[PaletteImage, np.ndarray]],
    segments_text: List[AnyRegion],
    segments_image: List[AnyRegion],
) -> str:
    """Draw the segments with ``method`` and save them under the
    prediction's base name; returns the written path.  A palette render
    becomes an indexed PNG, its palette cut after the last index used; other
    formats take its RGB pixels."""
    os.makedirs(output_dir, exist_ok=True)
    outfile = os.path.join(output_dir, f"{split_filename(prediction_path)[1]}.{extension}")
    image = method(orig_shape, label_colors, segments_text, segments_image)
    if isinstance(image, PaletteImage):
        if extension.lower() == "png":
            indices = image.indices
            n = int(indices.max()) + 1 if indices.size else 1
            imsave_indexed(outfile, indices, image.palette[:max(n, 1)])
            return outfile
        image = image.to_rgb()
    imsave(outfile, image)
    return outfile


# the reference's cv2-named alias
render_ocv_contours = render_contours
