"""Image resizing: host functions (numpy, scipy, PIL) and their device
counterparts (torch).

Counterpart of ``page_segmentation_tpu/ops/resize.py``.  The host functions
follow skimage's conventions (center-aligned coordinates
``src = (dst + 0.5) * in/out - 0.5``; order-0 by round-half-up; order-3 by
scipy's spline with mirror boundary and optional gaussian anti-aliasing,
sigma = (factor - 1) / 2) and give the JAX package's results exactly.  The
device functions are the torch counterparts of ``resize_nearest_jax`` and
``resize_cubic_jax``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- host
def output_shape_for_scale(shape: Sequence[int], scale: float) -> Tuple[int, ...]:
    """Output shape of skimage's rescale: round(dim * scale)."""
    return tuple(int(np.round(d * scale)) for d in shape)


def _nearest_index(out_dim: int, in_dim: int) -> np.ndarray:
    coords = (np.arange(out_dim) + 0.5) * (in_dim / out_dim) - 0.5
    return np.clip(np.floor(coords + 0.5).astype(np.int64), 0, in_dim - 1)


def resize_nearest(image: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """Order-0 resize that keeps values: the center-aligned mapping with
    round-half-up, clipped to bounds."""
    image = np.asarray(image)
    out_shape = tuple(int(s) for s in out_shape)
    if image.shape[: len(out_shape)] == out_shape:
        return image.copy()
    idx = [np.arange(in_dim) if out_dim == in_dim else _nearest_index(out_dim, in_dim)
           for out_dim, in_dim in zip(out_shape, image.shape)]
    if len(out_shape) == 2:
        return image[np.ix_(idx[0], idx[1])]
    return image[tuple(np.meshgrid(*idx, indexing="ij"))]


def rescale_nearest(image: np.ndarray, scale: float) -> np.ndarray:
    return resize_nearest(image, output_shape_for_scale(image.shape[:2], scale))


def resize_cubic(image: np.ndarray, out_shape: Sequence[int], anti_aliasing: bool = False,
                 preserve_range: bool = True) -> np.ndarray:
    """Order-3 spline resize with skimage.transform.resize semantics."""
    from scipy import ndimage as ndi

    image = np.asarray(image, dtype=np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    in_shape = image.shape[: len(out_shape)]
    if in_shape == out_shape:
        return image.copy()
    factors = np.array(in_shape, dtype=np.float64) / np.array(out_shape, dtype=np.float64)
    if anti_aliasing:
        sigma = np.maximum(0.0, (factors - 1.0) / 2.0)
        if np.any(sigma > 0):
            image = ndi.gaussian_filter(image, sigma, mode="mirror")
    coords = np.meshgrid(
        *[(np.arange(out_dim) + 0.5) * (in_dim / out_dim) - 0.5
          for out_dim, in_dim in zip(out_shape, in_shape)],
        indexing="ij",
    )
    return ndi.map_coordinates(image, np.stack(coords), order=3, mode="mirror")


def resize_cubic_fast(image: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """PIL bicubic resize: the fast host path (not bit-identical to the
    spline path)."""
    from PIL import Image

    out_shape = tuple(int(s) for s in out_shape)
    arr = np.asarray(image)
    pil = Image.fromarray(arr.astype(np.float32) if arr.dtype != np.uint8 else arr)
    return np.asarray(pil.resize((out_shape[1], out_shape[0]), Image.BICUBIC), dtype=np.float64)


# ------------------------------------------------------------------- device
def resize_nearest_torch(image: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """Order-0 resize on the tensor's device by a gather; the mapping of
    :func:`resize_nearest`.  (H, W[, ...]) -> (out_h, out_w[, ...])."""
    rows, cols = (torch.from_numpy(_nearest_index(int(o), int(i))).to(image.device)
                  for o, i in zip(out_shape, image.shape))
    return image[rows[:, None], cols[None, :]]


def resize_cubic_torch(image: torch.Tensor, out_shape: Sequence[int]) -> torch.Tensor:
    """Cubic resize on the tensor's device: Keys cubic (a = -0.5) with
    antialiasing, as ``jax.image.resize(method="cubic")``.  (H, W[, C])
    float -> (out_h, out_w[, C]) float32."""
    x = image.to(torch.float32)
    chw = x[None, None] if x.dim() == 2 else x.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=tuple(int(s) for s in out_shape[:2]), mode="bicubic",
                        antialias=True, align_corners=False)[0]
    return out[0] if x.dim() == 2 else out.permute(1, 2, 0)
