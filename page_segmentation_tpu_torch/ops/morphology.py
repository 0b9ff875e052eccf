"""Rectangular morphology: dilate, erode, close and open.

Counterpart of the JAX package's ``ops.morphology``.  The host functions
take any (H, W) or per-channel (H, W, C) array and give cv2's results:
``scipy.ndimage`` max/min filters with cv2's border (pixels outside the
image never win) and cv2's anchor (``k // 2``); the segmentation chain's
binary masks go through the native bit-packed kernel instead
(``segmentation.pc_segmentation.text_region_mask``).  ``dilate_torch`` /
``erode_torch`` are the device counterparts of ``dilate_jax`` /
``erode_jax``: a separable sliding max/min of shifted slices, which works
for every dtype on every device, with ``lax.reduce_window``'s "SAME"
window (anchor ``(k - 1) // 2``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _kernel_shape(kernel) -> Tuple[int, int]:
    if isinstance(kernel, np.ndarray):
        return kernel.shape[:2]
    kh, kw = kernel
    return int(kh), int(kw)


def _extreme(dtype, low: bool):
    dtype = np.dtype(dtype)
    if dtype == bool:
        return not low
    if dtype.kind in "iu":
        info = np.iinfo(dtype)
        return info.min if low else info.max
    return -np.inf if low else np.inf


def _filter(image: np.ndarray, kernel, iterations: int, maximum: bool) -> np.ndarray:
    from scipy import ndimage as ndi

    kh, kw = _kernel_shape(kernel)
    out = np.asarray(image)
    size = (kh, kw) + (1,) * (out.ndim - 2)
    fn = ndi.maximum_filter if maximum else ndi.minimum_filter
    for _ in range(int(iterations)):
        out = fn(out, size=size, mode="constant", cval=_extreme(out.dtype, low=maximum))
    return out


def dilate(image: np.ndarray, kernel=(3, 3), iterations: int = 1) -> np.ndarray:
    """cv2.dilate with a rectangular kernel; per channel on (H, W, C)."""
    return _filter(image, kernel, iterations, maximum=True)


def erode(image: np.ndarray, kernel=(3, 3), iterations: int = 1) -> np.ndarray:
    """cv2.erode with a rectangular kernel; per channel on (H, W, C)."""
    return _filter(image, kernel, iterations, maximum=False)


def morph_close(image: np.ndarray, kernel=(3, 3)) -> np.ndarray:
    return erode(dilate(image, kernel), kernel)


def morph_open(image: np.ndarray, kernel=(3, 3)) -> np.ndarray:
    return dilate(erode(image, kernel), kernel)


# ------------------------------------------------------------------- device
def sliding(x: torch.Tensor, k: int, anchor: int, dim: int, op, pad) -> torch.Tensor:
    """``out[i] = op`` over ``x[i - anchor : i - anchor + k]`` along ``dim``,
    cells outside reading ``pad``: sparse-table doubling, O(log2 k)
    combines of contiguous slices (no gather, no scan), then one combine of
    two overlapping power-of-two windows."""
    length = x.shape[dim]
    if k <= 1:
        return x
    shape = list(x.shape)
    shape[dim] = anchor
    before = x.new_full(shape, pad)
    shape[dim] = k - 1 - anchor
    table = torch.cat([before, x, x.new_full(shape, pad)], dim=dim)
    width = 1
    while width * 2 <= k:
        span = table.shape[dim] - width
        table = op(table.narrow(dim, 0, span), table.narrow(dim, width, span))
        width *= 2
    if width == k:
        return table.narrow(dim, 0, length)
    return op(table.narrow(dim, 0, length), table.narrow(dim, k - width, length))


def _window_torch(image: torch.Tensor, kernel, maximum: bool) -> torch.Tensor:
    kh, kw = _kernel_shape(kernel)
    if image.dtype == torch.bool:
        pad = not maximum
    elif image.dtype.is_floating_point:
        pad = float("-inf") if maximum else float("inf")
    else:
        info = torch.iinfo(image.dtype)
        pad = info.min if maximum else info.max
    op = torch.maximum if maximum else torch.minimum
    out = sliding(image, kh, (kh - 1) // 2, 0, op, pad)
    return sliding(out, kw, (kw - 1) // 2, 1, op, pad)


def dilate_torch(image: torch.Tensor, kernel=(3, 3)) -> torch.Tensor:
    """Max over a kh x kw window on the tensor's device; (H, W) or
    (H, W, C), the window of ``lax.reduce_window(..., "SAME")``."""
    return _window_torch(image, kernel, maximum=True)


def erode_torch(image: torch.Tensor, kernel=(3, 3)) -> torch.Tensor:
    return _window_torch(image, kernel, maximum=False)
