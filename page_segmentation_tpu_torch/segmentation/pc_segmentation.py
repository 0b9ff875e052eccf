"""Page segmentation from a pixel prediction.

Counterpart of the JAX package's ``segmentation.pc_segmentation``:
``find_segments`` (resize to a canonical height, 3x3 dilation, thresholds
from the char height, an XY cut per label, rectangles scaled back),
``find_segments_indexed`` (the same from a palette-index image), and
``get_text_contours`` (the char-height-sized close/open/dilate chain and
contour extraction for polygonal text regions).  Morphology, contours and
the canonical-height resize are the port's own ops (``ops.morphology``,
``ops.contours``, ``ops.resize.resize_nearest_cv``), each cv2-exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from ..core.colors import ColorMap, exact_color_mask
from ..ops import morphology
from ..ops.contours import fill_contour, find_external_contours
from ..ops.resize import resize_nearest_cv
from .xycut import CVContour, RectSegment, do_xy_cut

ColorMapping = Dict[str, np.ndarray]


def seg(left_upper: Tuple[int, int], right_lower: Tuple[int, int]) -> RectSegment:
    return RectSegment(left_upper[0], left_upper[1], right_lower[0], right_lower[1])


DEFAULT_COLOR_MAPPING = {
    "image": np.array([0, 255, 0]),
    "text": np.array([0, 0, 255]),
}


@dataclass(frozen=True)
class CutThresholds:
    """XY-cut decision thresholds at the canonical working scale.

    The int-truncation of ``char_height * factor`` is the behavioral
    contract: a projection row or
    column counts as occupied at one char height's worth of label pixels,
    and occupied runs split at gaps of two char heights (horizontal) or
    one (vertical).
    """

    occupied_px: int  # min label pixels for a row/column to count (both axes)
    gap_horizontal: int  # min empty-run length that splits, horizontal cuts
    gap_vertical: int  # ... vertical cuts

    @classmethod
    def at_scale(cls, char_height: int, factor: float) -> "CutThresholds":
        return cls(
            occupied_px=int(char_height * factor),
            gap_horizontal=int(char_height * 2 * factor),
            gap_vertical=int(char_height * factor),
        )

    def cut(self, label_mask: np.ndarray) -> List[RectSegment]:
        return do_xy_cut(
            label_mask,
            self.occupied_px,
            self.occupied_px,
            self.gap_horizontal,
            self.gap_vertical,
        )


def find_segments(
    orig_height: int,
    image: np.ndarray,
    char_height: int,
    resize_height: int,
    color_map: ColorMap,
    only_images: bool = False,
) -> Tuple[List[RectSegment], List[RectSegment]]:
    """XY-cut text/image segments from an RGB prediction image.

    Work at a canonical ``resize_height`` (so char_height-derived thresholds generalize across
    page sizes), dilate 3x3 to bridge hairline gaps, cut each label's
    pixel set, and report rectangles in the ORIGINAL page's coordinates —
    ``orig_height`` is the pre-prediction page height, which is why the
    rescale factor keys on it and not on ``image.shape``.
    """
    # the scale factor first, then applied: int(w * (rh/h)) and int(w*rh/h)
    # disagree on hundreds of (h, w) shapes (700x700 at rh=300: 299 vs 300).
    # resize_nearest_cv selects cv2's INTER_NEAREST pixels, not the skimage
    # convention of the dataset path.
    canonical_scale = resize_height / image.shape[0]
    canonical_w = int(image.shape[1] * canonical_scale)
    canonical = dilate(resize_nearest_cv(image, (resize_height, canonical_w)))
    return _cut_canonical(canonical, orig_height, char_height, resize_height,
                          color_map, only_images)


def find_segments_indexed(
    orig_height: int,
    labels: np.ndarray,
    palette: np.ndarray,
    char_height: int,
    resize_height: int,
    color_map: ColorMap,
    only_images: bool = False,
) -> Tuple[List[RectSegment], List[RectSegment]]:
    """``find_segments`` fast path for palette-indexed predictions.

    Nearest resize selects source *pixels*, so resizing the label map and
    palette-gathering RGB afterwards picks exactly the pixels
    ``find_segments`` would, with the 3-byte/px palette expansion at the
    small canonical scale (~300x212) instead of the full page.  The 3x3
    RGB dilation and the cut are shared.
    """
    canonical_scale = resize_height / labels.shape[0]
    canonical_w = int(labels.shape[1] * canonical_scale)
    small = resize_nearest_cv(labels, (resize_height, canonical_w))
    palette = np.asarray(palette, np.uint8)
    canonical = dilate(palette[small])
    return _cut_canonical(canonical, orig_height, char_height, resize_height,
                          color_map, only_images)


def _cut_canonical(
    canonical: np.ndarray,
    orig_height: int,
    char_height: int,
    resize_height: int,
    color_map: ColorMap,
    only_images: bool,
) -> Tuple[List[RectSegment], List[RectSegment]]:
    to_canonical = resize_height / orig_height
    thresholds = CutThresholds.at_scale(char_height, to_canonical)

    def segments_for(label: str) -> List[RectSegment]:
        rects = thresholds.cut(color_map.filter_label(canonical, label))
        return [r.scale(1.0 / to_canonical) for r in rects]

    segments_image = segments_for("image")
    segments_text = [] if only_images else segments_for("text")
    return segments_text, segments_image


def dilate(bin_image: np.ndarray) -> np.ndarray:
    """3x3 dilation; per channel on RGB."""
    return morphology.dilate(bin_image, (3, 3), iterations=1)


def text_region_mask(mask: np.ndarray, char_height: int) -> np.ndarray:
    """The char-height-sized morphology chain of a text-pixel mask on the
    host: close(k) fills holes, open(k/3) drops specks, dilate(k/1.1) grows
    characters into line and region blobs, close(k/1.1) closes them.  A
    (H, W) mask takes the native bit-packed chain (``native.
    bitmorph_chain``, 0/255); the cv2-exact composition of
    ``ops.morphology`` is its plain version."""
    from .device_morph import morph_kernels

    k, k3, k11 = morph_kernels(char_height)
    if mask.ndim == 2:
        from .. import native

        return native.bitmorph_chain(mask, k, k3, k11)
    mask = morphology.morph_close(mask, (k, k))
    mask = morphology.morph_open(mask, (k3, k3))
    region_chars = morphology.dilate(mask, (k11, k11), iterations=1)
    return morphology.morph_close(region_chars, (k11, k11))


def contours_from_region_mask(region_text: np.ndarray) -> List[CVContour]:
    """Final contour extraction from a processed region mask.

    Fill region polygons so enclosed holes vanish, then extract the final
    contours (the reference's draw-then-refind).  The refind can only
    differ from the first find by swallowing components nested inside
    another component's hole; nesting requires bounding-box containment,
    so when no contour's box lies inside another's the second pass is
    skipped.
    """
    contours = find_external_contours(region_text)
    if _any_bbox_nested(contours):
        filled = np.zeros(region_text.shape, np.uint8)
        for contour in contours:
            fill_contour(filled, contour, 255)
        contours = find_external_contours(filled)
    # reverse to preserve the reference's region ordering
    return [CVContour(c) for c in contours[::-1]]


def get_text_contours(image: np.ndarray, char_height: int, color_map: ColorMap) -> List[CVContour]:
    """Polygonal text regions by char-height-scaled morphology."""
    mask = exact_color_mask(image, color_map.color_for_label("text"))
    return contours_from_region_mask(text_region_mask(mask, char_height))


def get_text_contours_batch(
    masks,
    char_heights,
    device_morph=None,
) -> List[List[CVContour]]:
    """Batched text contours from text-pixel masks — an (N, H, W) array
    or a sequence of 2-D masks (shapes may differ page to page).

    With ``device_morph`` (a :class:`~.device_morph.TextRegionMorphDevice`)
    the chain runs on its device, one batch for all pages; without it the
    host chain runs per page.  Both give the same contours.
    """
    from .device_morph import morph_kernels

    if device_morph is not None:
        kernels = [morph_kernels(ch) for ch in char_heights]
        regions = device_morph.run(np.asarray(masks, bool), kernels)
        return [contours_from_region_mask(regions[i])
                for i in range(regions.shape[0])]

    def as_u8(mask: np.ndarray) -> np.ndarray:
        # a bool mask is a 0/1 uint8 mask of the same bytes; the chain
        # tests nonzero
        return mask.view(np.uint8) if mask.dtype == bool else \
            np.asarray(mask, np.uint8)

    return [
        contours_from_region_mask(text_region_mask(as_u8(masks[i]), ch))
        for i, ch in enumerate(char_heights)
    ]


def _any_bbox_nested(contours: List[np.ndarray]) -> bool:
    """True iff some contour's bounding box lies (inclusively) inside
    another's.  Polygon nesting implies box containment, so False proves
    the fill-then-refind an identity.  Vectorized over the (n, 4) boxes:
    noisy pages emit thousands of contours."""
    if len(contours) < 2:
        return False
    boxes = np.array(
        [(c[:, 0].min(), c[:, 1].min(), c[:, 0].max(), c[:, 1].max())
         for c in contours],
        np.int64,
    )
    n = len(boxes)
    b = boxes[None, :, :]  # candidate container boxes
    # 512-row blocks of the candidate-contained axis: the full n x n
    # broadcast is >10 GB at the contour counts of a speckled page with
    # char_height 1
    for start in range(0, n, 512):
        a = boxes[start : start + 512, None, :]
        contained = (
            (a[..., 0] >= b[..., 0]) & (a[..., 1] >= b[..., 1])
            & (a[..., 2] <= b[..., 2]) & (a[..., 3] <= b[..., 3])
        )
        # a box "contains" itself: mask the diagonal of this block
        idx = np.arange(start, min(start + 512, n))
        contained[idx - start, idx] = False
        if contained.any():
            return True
    return False
