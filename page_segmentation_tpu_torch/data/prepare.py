"""Canonical page preprocessing: a copy of
``page_segmentation_tpu/data/prepare.py``.

* ``scale = target_line_height / line_height_px``
* binary: normalized to 0/1, nearest-rescaled by ``scale``, then inverted
  (``1 - x``; ink becomes 1), uint8 0/1;
* image: cubic-resized to the binary's shape (anti-aliased iff it has more
  than two values), normalized and inverted, uint8 0..255;
* an optional ``max_width`` downscale of both.

Two host backends: ``scipy`` (spline, the parity path) and ``pil`` (PIL's
bicubic, the fast path).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.resize import output_shape_for_scale, rescale_nearest, resize_cubic, resize_cubic_fast, resize_nearest


def _more_than_two_values(img: np.ndarray) -> bool:
    """``len(np.unique(img)) > 2`` without the sort."""
    flat = img.ravel()
    if flat.size == 0:
        return False
    first = flat[0]
    differs = flat != first
    if not differs.any():
        return False
    second = flat[np.argmax(differs)]
    return bool((differs & (flat != second)).any())


def _scale_image(img: np.ndarray, target_shape, backend: str) -> np.ndarray:
    if backend == "pil":
        return resize_cubic_fast(img, target_shape)
    return resize_cubic(img, target_shape, anti_aliasing=_more_than_two_values(img))


def prepare_images(
    image: np.ndarray,
    binary: np.ndarray,
    target_line_height: int,
    line_height_px: int,
    max_width: Optional[int] = None,
    keep_orig_bin: bool = False,
    resize_backend: str = "scipy",
) -> Tuple[np.ndarray, ...]:
    scale = target_line_height / line_height_px

    binary = np.asarray(binary)
    # gather first, normalize the small result (the nearest gather commutes
    # with the pointwise /255)
    bin_255 = np.max(binary) > 1
    bin_small = np.asarray(rescale_nearest(binary, scale), dtype=np.float64)
    bin_scaled = 1.0 - (bin_small / 255 if bin_255 else bin_small)
    image = np.asarray(image)
    if resize_backend == "pil" and image.dtype == np.uint8:
        # resize the raw uint8 page with PIL's integer bicubic, invert after
        img = 1.0 - resize_cubic_fast(image, bin_scaled.shape) / 255
    else:
        img = 1.0 - _scale_image(image.astype(np.float64), bin_scaled.shape, resize_backend) / 255

    if max_width is not None:
        n_scale = max_width / bin_scaled.shape[1]
        if n_scale < 1.0:
            bin_scaled = rescale_nearest(bin_scaled, n_scale)
            img = _scale_image(img, bin_scaled.shape, resize_backend)

    # the reference casts straight to uint8, so cubic-overshoot values WRAP
    # modulo 256 (e.g. 271 -> 15); kept verbatim: models trained on
    # reference-prepared inputs saw those exact pixels at sharp ink edges
    img = (img * 255).astype(np.uint8)
    bin_scaled = bin_scaled.astype(np.uint8)
    if keep_orig_bin:
        orig_bin = binary / 255 if bin_255 else binary
        return img, bin_scaled, (1 - orig_bin).astype(np.uint8)
    return img, bin_scaled


def prepared_shape(
    binary_shape: Tuple[int, int],
    target_line_height: int,
    line_height_px: int,
    max_width: Optional[int] = None,
) -> Tuple[int, int]:
    """Output shape of :func:`prepare_images` without touching any pixels."""
    scale = target_line_height / line_height_px
    shape = output_shape_for_scale(binary_shape[:2], scale)
    if max_width is not None:
        n_scale = max_width / shape[1]
        if n_scale < 1.0:
            shape = output_shape_for_scale(shape, n_scale)
    return shape


def prepare_mask(mask_labels: np.ndarray, scaled_shape) -> np.ndarray:
    """Nearest-resize a label mask to the prepared image shape."""
    return resize_nearest(np.asarray(mask_labels), scaled_shape).astype(np.uint8)
