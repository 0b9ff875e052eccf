"""Batched binary morphology of the segmentation stage on the card.

Counterpart of the JAX package's ``segmentation.device_morph``.  The
``--text_contours`` mode closes, opens and dilates each page's text mask
with boxes sized by its char height (``text_region_chain``).  Here that
chain runs as torch ops on the requested device, batched over pages: each
box is a separable sliding OR (dilate) or AND (erode) of shifted slices of
a bool tensor, O(log2 k) combines per axis whatever the box size
(``ops.morphology.sliding``).  The borders are cv2's: for a dilation, cells
outside the page add no foreground; for an erosion they count as
foreground; the anchor is ``k // 2`` for odd and even ``k``.

``TextRegionMorphDevice`` keeps the JAX module's batching: masks go up
1-bit packed, are unpacked on the device (``inference.output.
unpack_bits_device``), run one chain per distinct kernel triple of the
batch with a per-page select, the batch padded to a power of two, and come
back 1-bit packed.  Unlike the JAX module, the chain runs on the page's own
columns only, not on the row padding to a multiple of 8: an erosion there
would read the padding as background pixels of the page instead of as
foreground beyond its edge, so pages whose width is not a multiple of 8
gave other masks near their right edge than the host chain.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.morphology import sliding


def morph_kernels(char_height: int) -> Tuple[int, int, int]:
    """The chain's three box sizes ``(k, k / 3, k / 1.1)``, each truncated
    by ``int()`` and at least 1."""
    return (
        max(int(char_height), 1),
        max(int(char_height / 3), 1),
        max(int(char_height / 1.1), 1),
    )


def dilate_box(mask: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.dilate of an (N, H, W) bool tensor with a kh x kw box."""
    m = sliding(mask, kh, kh // 2, 1, torch.logical_or, False)
    return sliding(m, kw, kw // 2, 2, torch.logical_or, False)


def erode_box(mask: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """cv2.erode of an (N, H, W) bool tensor with a kh x kw box."""
    m = sliding(mask, kh, kh // 2, 1, torch.logical_and, True)
    return sliding(m, kw, kw // 2, 2, torch.logical_and, True)


def text_region_chain(mask: torch.Tensor, kernels: Tuple[int, int, int]) -> torch.Tensor:
    """close(k), open(k3), dilate(k11), close(k11) of an (N, H, W) bool
    text mask, ``kernels`` = ``morph_kernels(char_height)``."""
    k, k3, k11 = (int(v) for v in kernels)
    m = erode_box(dilate_box(mask, k, k), k, k)
    m = dilate_box(erode_box(m, k3, k3), k3, k3)
    m = dilate_box(m, k11, k11)
    return erode_box(dilate_box(m, k11, k11), k11, k11)


# byte -> its 8 mask pixels (MSB first) as 0/255
_UNPACK_LUT = np.where(
    (np.arange(256)[:, None] >> np.arange(7, -1, -1)) & 1, np.uint8(255), np.uint8(0)
).astype(np.uint8)


def _chain_packed(packed: torch.Tensor, assign: torch.Tensor, triples, w: int) -> torch.Tensor:
    from ..inference.output import unpack_bits_device

    # the chain sees the page's own w columns: padding columns read as page
    # pixels would end the erosions' border-as-foreground rule at the edge
    mask = unpack_bits_device(packed)[..., :w]
    region = text_region_chain(mask, triples[0])
    for t, triple in enumerate(triples[1:], start=1):
        region = torch.where((assign == t)[:, None, None], text_region_chain(mask, triple), region)
    n, h, _ = region.shape
    w8 = packed.shape[-1] * 8
    if w8 != w:
        region = torch.cat([region, region.new_zeros(n, h, w8 - w)], dim=2)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=region.device)
    return (region.reshape(n, h, w8 // 8, 8).to(torch.uint8) * weights).sum(-1, dtype=torch.uint8)


class TextRegionMorphDevice:
    """The text-contours chain for batches of pages on ``device``.

    :meth:`dispatch` packs, uploads and enqueues a batch and returns at
    once (CUDA runs it asynchronously), so that the caller finishes the
    previous batch meanwhile; :meth:`collect` downloads and unpacks it.
    Pages of one batch may have different char heights: the chain runs
    once for each distinct kernel triple, and each page takes its own
    result.  ``device="cuda"`` without a card raises."""

    def __init__(self, device="cuda"):
        from ..device import resolve_device

        self.device = resolve_device(device)

    def dispatch(self, masks: np.ndarray, kernels):
        """``masks``: (N, H, W) bool; ``kernels``: one (k, k3, k11) triple
        for the batch, or one per page."""
        n, h, w = masks.shape
        if isinstance(kernels[0], (int, np.integer)):
            kernels = [tuple(int(k) for k in kernels)] * n
        else:
            kernels = [tuple(int(k) for k in t) for t in kernels]
        triples = tuple(sorted(set(kernels)))
        w8 = -(-w // 8) * 8
        n_pad = 1 << max(0, n - 1).bit_length()
        if w8 != w or n_pad != n:
            padded = np.zeros((n_pad, h, w8), bool)
            padded[:n, :, :w] = masks
            masks = padded
        packed = torch.from_numpy(np.packbits(masks, axis=-1))
        assign = torch.zeros(n_pad, dtype=torch.int32)
        assign[:n] = torch.tensor([triples.index(t) for t in kernels], dtype=torch.int32)
        if self.device.type == "cuda":
            packed, assign = packed.pin_memory(), assign.pin_memory()
        out = _chain_packed(packed.to(self.device, non_blocking=True),
                            assign.to(self.device, non_blocking=True), triples, w)
        return out, n, w

    def collect(self, handle) -> np.ndarray:
        """(N, H, W) uint8 0/255 region masks of a :meth:`dispatch`."""
        out, n, w = handle
        packed = out.cpu().numpy()
        n_pad, h, w8 = packed.shape
        return _UNPACK_LUT[packed].reshape(n_pad, h, w8 * 8)[:n, :, :w]

    def run(self, masks: np.ndarray, kernels) -> np.ndarray:
        return self.collect(self.dispatch(masks, kernels))
