"""Batched affine augmentation on the device (the trainer's opt-in
``device_augmentation``).

Counterpart of ``page_segmentation_tpu/data/augment_device.py``, as torch
ops on the batch's device: one random affine per page, drawn from a JAX
key as the JAX function draws it (``ops/prng.py``: ``split(key, 3)`` into
the matrices' key and the two flips' keys, ``split(key_mat, 6)`` into
θ, tx, ty, shear, zx, zy, each a ``jax.random.uniform`` of the batch's
pages, the flips ``bernoulli(0.5)``; the uniform kernel on the card, so the
parameters never leave it), shared by the image (bilinear), the binary and
the mask (nearest), with the ``nearest`` fill (source coordinates clamped
to the page).  Parameter semantics are the host path's (``data/augment.py``);
the image interpolation is bilinear instead of the cubic spline.  A shard
of a mesh batch takes its rows of the draw for the whole batch, as the JAX
function runs once over the sharded batch.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.prng import Key, bernoulli, split, uniform

# jnp.deg2rad's factor, rounded to float32 as JAX rounds it
_DEG2RAD = float(np.float32(np.pi / 180))


class DeviceAugmentConfig(NamedTuple):
    rotation_range: float = 2.5  # degrees
    width_shift_range: float = 0.025
    height_shift_range: float = 0.025
    shear_range: float = 0.0
    zoom_min: float = 0.95
    zoom_max: float = 1.05
    horizontal_flip: bool = False
    vertical_flip: bool = False


def _sample_matrices(key: Key, n: int, h: int, w: int, cfg: DeviceAugmentConfig,
                     device="cpu") -> torch.Tensor:
    """(n, 2, 3) float32 maps from output to input (row, col) coordinates,
    Keras' composition about the page centre."""
    keys = split(key, 6)

    def draw(i, low, high):
        return uniform(keys[i], (n,), low, high, device)

    theta = draw(0, -cfg.rotation_range, cfg.rotation_range) * _DEG2RAD
    tx = draw(1, -cfg.height_shift_range, cfg.height_shift_range) * (
        h if cfg.height_shift_range < 1 else 1.0)
    ty = draw(2, -cfg.width_shift_range, cfg.width_shift_range) * (
        w if cfg.width_shift_range < 1 else 1.0)
    shear = draw(3, -cfg.shear_range, cfg.shear_range) * _DEG2RAD
    zx = draw(4, cfg.zoom_min, cfg.zoom_max)
    zy = draw(5, cfg.zoom_min, cfg.zoom_max)

    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    # rotation @ shift @ shear @ zoom in (x, y): the affine's two rows
    a00 = cos_t * zx
    a01 = (-cos_t * torch.sin(shear) - sin_t * torch.cos(shear)) * zy
    a02 = cos_t * tx - sin_t * ty
    a10 = sin_t * zx
    a11 = (-sin_t * torch.sin(shear) + cos_t * torch.cos(shear)) * zy
    a12 = sin_t * tx + cos_t * ty

    # offset about the centre, then swap into (row, col)
    o_x = h / 2.0 - 0.5
    o_y = w / 2.0 - 0.5
    b0 = a02 + o_x - (a00 * o_x + a01 * o_y)
    b1 = a12 + o_y - (a10 * o_x + a11 * o_y)
    # row' = a11*row + a10*col + b1 ; col' = a01*row + a00*col + b0
    return torch.stack([torch.stack([a11, a10, b1], dim=-1),
                        torch.stack([a01, a00, b0], dim=-1)], dim=1)


def _gather(img: torch.Tensor, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """img[i, r[i], c[i]] per page: (N, H, W) with (N, H, W) int64 indices."""
    n, h, w = img.shape
    flat = (r * w + c).reshape(n, -1)
    return img.reshape(n, -1).gather(1, flat).reshape(n, h, w)


def _warp(img: torch.Tensor, mat: torch.Tensor, order: int) -> torch.Tensor:
    """(N, H, W) pages through (N, 2, 3) maps: order 0 nearest (rounding
    half to even, as ``jnp.round``) in the pages' dtype, order 1 bilinear in
    float32."""
    n, h, w = img.shape
    rows = torch.arange(h, dtype=torch.float32, device=img.device)[:, None].expand(h, w)
    cols = torch.arange(w, dtype=torch.float32, device=img.device)[None, :].expand(h, w)
    m = mat.to(torch.float32)[:, :, :, None, None]  # (N, 2, 3, 1, 1)
    src_r = (m[:, 0, 0] * rows + m[:, 0, 1] * cols + m[:, 0, 2]).clamp(0.0, h - 1.0)
    src_c = (m[:, 1, 0] * rows + m[:, 1, 1] * cols + m[:, 1, 2]).clamp(0.0, w - 1.0)
    if order == 0:
        return _gather(img, torch.round(src_r).long(), torch.round(src_c).long())
    r0 = torch.floor(src_r).long()
    c0 = torch.floor(src_c).long()
    r1 = (r0 + 1).clamp_max(h - 1)
    c1 = (c0 + 1).clamp_max(w - 1)
    fr = src_r - r0
    fc = src_c - c0
    img_f = img.to(torch.float32)
    top = _gather(img_f, r0, c0) * (1 - fc) + _gather(img_f, r0, c1) * fc
    bottom = _gather(img_f, r1, c0) * (1 - fc) + _gather(img_f, r1, c1) * fc
    return top * (1 - fr) + bottom * fr


def augment_batch_on_device(key: Key, images: torch.Tensor, binaries: torch.Tensor,
                            masks: torch.Tensor, cfg: DeviceAugmentConfig, offset: int = 0,
                            total: Optional[int] = None):
    """One shared random affine per page across the triple, drawn from
    ``key`` as the JAX function draws it.

    images (N, H, W, C) float32, binaries (N, H, W) uint8, masks (N, H, W)
    integer, all on one device.  The image warps bilinear, the binary and
    mask nearest; the flips are drawn per page when enabled.  The pages are
    rows ``offset .. offset + N`` of a batch of ``total`` pages (default N):
    each takes its row's draw."""
    n, h, w = images.shape[:3]
    total = n if total is None else total
    rows = slice(offset, offset + n)
    key_mat, key_flip_h, key_flip_v = split(key, 3)
    mats = _sample_matrices(key_mat, total, h, w, cfg, images.device)[rows]
    img_out = torch.stack([_warp(images[..., c], mats, 1) for c in range(images.shape[-1])], dim=-1)
    bin_out = _warp(binaries, mats, 0)
    mask_out = _warp(masks, mats, 0)
    for enabled, flip_key, dim in ((cfg.horizontal_flip, key_flip_h, 2), (cfg.vertical_flip, key_flip_v, 1)):
        if enabled:
            pick = bernoulli(flip_key, 0.5, (total,), images.device)[rows].view(n, 1, 1)
            img_out = torch.where(pick[..., None], img_out.flip(dim), img_out)
            bin_out = torch.where(pick, bin_out.flip(dim), bin_out)
            mask_out = torch.where(pick, mask_out.flip(dim), mask_out)
    return img_out, bin_out, mask_out
