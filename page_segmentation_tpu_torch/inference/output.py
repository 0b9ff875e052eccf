"""Output packing and the host mask trio for the predict path.

Counterparts of ``page_segmentation_tpu/inference/output.py``:

* :func:`pack_classes_device` / :func:`unpack_classes` — 2-bit class codes,
  4 pixels per byte, **LSB-first** (pixel x of a byte is
  ``(b >> 2*(x & 3)) & 3``, as ``ps_native.cpp`` reads it);
* :func:`pack_bits_host` / :func:`unpack_bits_device` — the 1-bit ink
  upload, **MSB-first** (``np.packbits`` order);
* :func:`finish_mask_trio` — color/overlay/inverted from a class map and
  the ink mask (native C).
"""
from __future__ import annotations

import numpy as np
import torch


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
