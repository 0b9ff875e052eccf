"""Output masks, packing and the host mask trio for the predict paths.

Counterparts of ``page_segmentation_tpu/inference/output.py``:

* :class:`Masks`, :func:`generate_output_masks`, :func:`output_data` and
  :func:`scale_to_original_shape` — the per-page mask products and their
  color/overlay/inverted directory layout; :func:`masks_on_device` computes
  the same products from logits on the device;
* :func:`pack_classes_device` / :func:`unpack_classes` — 2-bit class codes,
  4 pixels per byte, **LSB-first** (pixel x of a byte is
  ``(b >> 2*(x & 3)) & 3``, as ``ps_native.cpp`` reads it);
* :func:`pack_bits_host` / :func:`unpack_bits_device` — the 1-bit ink
  upload, **MSB-first** (``np.packbits`` order);
* :func:`finish_mask_trio` — color/overlay/inverted from a class map and
  the ink mask (native C).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..core.colors import ColorMap
from ..core.image_io import imsave
from ..data.dataset import SingleData
from ..ops.resize import resize_nearest


@dataclass
class Masks:
    color: np.ndarray
    overlay: np.ndarray
    inverted_overlay: np.ndarray
    fg_color_mask: Optional[np.ndarray] = None


def generate_output_masks(data: SingleData, pred: np.ndarray, color_map: ColorMap) -> Masks:
    """The four mask products, keyed on the prepared binary's exact values
    (ink == 1, paper == 0): ``overlay`` drops ink pixels,
    ``inverted_overlay`` drops paper pixels, ``fg_color_mask`` keeps ink
    pixels only."""
    color = color_map.to_rgb_array(pred)
    binary = np.asarray(data.binary)
    is_ink = (binary == 1)[..., None]
    is_paper = (binary == 0)[..., None]
    return Masks(
        color=color,
        overlay=np.where(is_ink, np.uint8(0), color),
        inverted_overlay=np.where(is_paper, np.uint8(0), color),
        fg_color_mask=np.where(is_ink, color, np.uint8(0)),
    )


def output_data(output_dir, pred: np.ndarray, data: SingleData, color_map: ColorMap) -> None:
    """Write the color/overlay/inverted trio of one page under
    ``output_dir/{color,overlay,inverted}/``; an absolute ``output_path``
    puts the three subdirectories beside it instead."""
    if pred.ndim == 3:
        if pred.shape[0] != 1:
            raise ValueError(f"one page expected, got a batch of {pred.shape[0]}")
        pred = pred[0]
    categories = ("color", "overlay", "inverted")
    if data.output_path:
        filename = data.output_path
        directory = os.path.dirname(filename)
        if os.path.isabs(directory):
            base = os.path.basename(filename)
            masks = generate_output_masks(data, pred, color_map)
            for category, mask in zip(categories, (masks.color, masks.overlay,
                                                   masks.inverted_overlay)):
                os.makedirs(os.path.join(directory, category), exist_ok=True)
                imsave(os.path.join(directory, category, base), mask)
            return
        if directory:
            for category in categories:
                os.makedirs(os.path.join(output_dir, category, directory), exist_ok=True)
    else:
        filename = os.path.basename(data.image_path)
    masks = generate_output_masks(data, pred, color_map)
    for category, mask in zip(categories, (masks.color, masks.overlay, masks.inverted_overlay)):
        imsave(os.path.join(output_dir, category, filename), mask)


def scale_to_original_shape(data: SingleData, pred: np.ndarray):
    """(data at the original page shape, pred nearest-resized to it)."""
    resized_image = resize_nearest(data.image, data.original_shape)
    pred = resize_nearest(pred, data.original_shape).astype("int64")
    if data.binary.shape != data.original_shape:
        if data.orig_binary is not None:
            resized_binary = data.orig_binary
        else:
            resized_binary = resize_nearest(data.binary, data.original_shape).astype(bool)
    else:
        resized_binary = data.binary
    return replace(data, binary=resized_binary, image=resized_image), pred


def masks_on_device(logits: torch.Tensor, binary: torch.Tensor, palette: torch.Tensor):
    """The mask products on the logits' device: logits (..., H, W, C),
    binary (..., H, W) with nonzero = ink, palette (n_classes, 3) uint8 ->
    (pred int32, color, overlay, inverted) tensors, as
    :func:`generate_output_masks` renders them."""
    pred = logits.argmax(dim=-1).to(torch.int32)
    color = palette[pred.clamp(0, palette.shape[0] - 1).long()]
    ink = (binary != 0)[..., None]
    zero = torch.zeros((), dtype=color.dtype, device=color.device)
    return pred, color, torch.where(ink, zero, color), torch.where(ink, color, zero)


def pack_classes_device(pred: torch.Tensor) -> torch.Tensor:
    """(N, H, W) class map (classes < 4, W % 4 == 0) -> (N, H, W // 4) uint8."""
    n, h, w = pred.shape
    quads = pred.to(torch.uint8).view(n, h, w // 4, 4)
    return (quads[..., 0] | (quads[..., 1] << 2) | (quads[..., 2] << 4)
            | (quads[..., 3] << 6))


def unpack_classes(packed: np.ndarray) -> np.ndarray:
    """Host inverse of :func:`pack_classes_device`: (N, H, W//4) uint8 ->
    (N, H, W) uint8 class map."""
    quads = (packed[..., None] >> np.uint8([0, 2, 4, 6])) & np.uint8(3)
    return quads.reshape(packed.shape[0], packed.shape[1], -1)


def pack_bits_host(mask: np.ndarray) -> np.ndarray:
    """(..., W) 0/1 mask -> (..., W // 8) uint8, MSB-first (W % 8 == 0)."""
    return np.packbits(np.asarray(mask, bool), axis=-1)


def unpack_bits_device(packed: torch.Tensor) -> torch.Tensor:
    """Device inverse of :func:`pack_bits_host`: (..., W//8) uint8 ->
    (..., W) bool, MSB-first."""
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (packed.shape[-1] * 8,)).bool()


def finish_mask_trio(pred: np.ndarray, ink: np.ndarray, palette: np.ndarray, out=None):
    """(color, overlay, inverted) for a batch of (padded) class maps and
    their ink masks, cropped to the ink's shape; ``out`` optionally gives
    preallocated uint8 buffers to write into."""
    from .. import native

    return native.finish_masks(pred, np.asarray(ink, np.uint8), palette, out=out)
