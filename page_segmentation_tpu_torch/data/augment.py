"""Seeded affine augmentation of a training page on the host.

Counterpart of ``page_segmentation_tpu/data/augment.py``: one random affine
(rotation, shift, shear, zoom, flips, optional brightness) is drawn per page
from a ``numpy.random.Generator`` and applied alike to the image (spline
order 3), the binary and the mask (order 0), with scipy's ``nearest`` fill.
The matrix follows Keras' ``ImageDataGenerator``: rotation @ shift @ shear
@ zoom in (x, y), offset about the page centre (dim / 2 - 0.5), then swapped
into scipy's (row, col) order.  The same generator state gives the same
triple as the JAX package, bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass
class AffineParams:
    theta: float = 0.0  # degrees
    tx: float = 0.0  # pixels (rows)
    ty: float = 0.0  # pixels (cols)
    shear: float = 0.0  # degrees
    zx: float = 1.0
    zy: float = 1.0
    flip_horizontal: bool = False
    flip_vertical: bool = False
    brightness: Optional[float] = None


def sample_affine_params(
    rng: np.random.Generator,
    shape: Tuple[int, int],
    rotation_range: float = 0.0,
    width_shift_range: float = 0.0,
    height_shift_range: float = 0.0,
    shear_range: float = 0.0,
    zoom_range=(1.0, 1.0),
    horizontal_flip: bool = False,
    vertical_flip: bool = False,
    brightness_range=None,
) -> AffineParams:
    """One page's transform; the draws happen in the JAX package's order."""
    h, w = shape
    theta = float(rng.uniform(-rotation_range, rotation_range)) if rotation_range else 0.0
    tx = ty = 0.0
    if height_shift_range:
        tx = float(rng.uniform(-height_shift_range, height_shift_range))
        if height_shift_range < 1:
            tx *= h
    if width_shift_range:
        ty = float(rng.uniform(-width_shift_range, width_shift_range))
        if width_shift_range < 1:
            ty *= w
    shear = float(rng.uniform(-shear_range, shear_range)) if shear_range else 0.0
    if zoom_range[0] == 1 and zoom_range[1] == 1:
        zx = zy = 1.0
    else:
        zx, zy = (float(z) for z in rng.uniform(zoom_range[0], zoom_range[1], 2))
    flip_h = horizontal_flip and bool(rng.random() < 0.5)
    flip_v = vertical_flip and bool(rng.random() < 0.5)
    brightness = (
        float(rng.uniform(brightness_range[0], brightness_range[1])) if brightness_range else None
    )
    return AffineParams(theta, tx, ty, shear, zx, zy, flip_h, flip_v, brightness)


def _offset_center(matrix: np.ndarray, h: int, w: int) -> np.ndarray:
    o_x = float(h) / 2 - 0.5
    o_y = float(w) / 2 - 0.5
    offset = np.array([[1, 0, o_x], [0, 1, o_y], [0, 0, 1]])
    reset = np.array([[1, 0, -o_x], [0, 1, -o_y], [0, 0, 1]])
    return offset @ matrix @ reset


def affine_matrix(params: AffineParams, shape: Tuple[int, int]) -> np.ndarray:
    """The 3x3 homogeneous transform in scipy's (row, col) order."""
    matrix = np.eye(3)
    if params.theta:
        t = np.deg2rad(params.theta)
        matrix = matrix @ np.array(
            [[np.cos(t), -np.sin(t), 0], [np.sin(t), np.cos(t), 0], [0, 0, 1]]
        )
    if params.tx or params.ty:
        matrix = matrix @ np.array([[1, 0, params.tx], [0, 1, params.ty], [0, 0, 1]])
    if params.shear:
        s = np.deg2rad(params.shear)
        matrix = matrix @ np.array([[1, -np.sin(s), 0], [0, np.cos(s), 0], [0, 0, 1]])
    if params.zx != 1 or params.zy != 1:
        matrix = matrix @ np.array([[params.zx, 0, 0], [0, params.zy, 0], [0, 0, 1]])
    if not np.allclose(matrix, np.eye(3)):
        matrix = _offset_center(matrix, shape[0], shape[1])
        # P M P with the axis swap: Keras' (x, y) -> numpy's (row, col)
        matrix = matrix.copy()
        matrix[:, [0, 1]] = matrix[:, [1, 0]]
        matrix[[0, 1]] = matrix[[1, 0]]
    return matrix


def apply_affine(
    image: np.ndarray,
    params: AffineParams,
    order: int,
    fill_mode: str = "nearest",
    cval: float = 0.0,
) -> np.ndarray:
    """The transform applied to one (H, W) or (H, W, C) array."""
    from scipy import ndimage as ndi

    matrix = affine_matrix(params, image.shape[:2])
    out = image
    if not np.allclose(matrix, np.eye(3)):
        linear = matrix[:2, :2]
        offset = matrix[:2, 2]
        if out.ndim == 2:
            out = ndi.affine_transform(
                out, linear, offset=offset, order=order, mode=fill_mode, cval=cval
            )
        else:
            out = np.stack(
                [
                    ndi.affine_transform(
                        out[..., c], linear, offset=offset, order=order, mode=fill_mode, cval=cval
                    )
                    for c in range(out.shape[-1])
                ],
                axis=-1,
            )
    if params.flip_horizontal:
        out = out[:, ::-1]
    if params.flip_vertical:
        out = out[::-1]
    if params.brightness is not None:
        out = np.clip(out.astype(np.float64) * params.brightness, 0, 255).astype(image.dtype)
    return out


def augment_triple(
    image: np.ndarray,
    binary: Optional[np.ndarray],
    mask: np.ndarray,
    params: AffineParams,
    settings,
):
    """One shared transform: the image at order 3, the binary and mask at
    order 0 and without brightness, each with its fill mode and value from
    ``settings`` (an ``AugmentationSettings``)."""
    no_brightness = AffineParams(**{**params.__dict__, "brightness": None})
    image_out = apply_affine(
        image, params, order=3, fill_mode=settings.image_fill_mode, cval=settings.image_cval
    )
    binary_out = (
        apply_affine(
            binary, no_brightness, order=0, fill_mode=settings.binary_fill_mode, cval=settings.binary_cval
        )
        if binary is not None
        else None
    )
    mask_out = apply_affine(
        mask, no_brightness, order=0, fill_mode=settings.mask_fill_mode, cval=settings.mask_cval
    )
    return image_out, binary_out, mask_out
