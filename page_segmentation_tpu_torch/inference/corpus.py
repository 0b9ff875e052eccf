"""Raw-corpus streaming prediction: the throughput path as a user feature.

Counterpart of ``page_segmentation_tpu/inference/corpus.py``.
``RawCorpusPredictor`` takes raw full-resolution page files and writes the
color/overlay/inverted trio through ``ThroughputPredictor``: pages grouped by
(shape, line height), decoded a window at a time on a prefetch thread into
a reusable ring of buffers, host box-decimation, one uint8 upload and one
packed download per batch, normalize/forward/argmax on the device, and the
3-stage overlap.  ``predict --pipeline`` runs it.  Outputs are at the
normalized (line-height-rescaled) page scale.
"""
from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.image_io import image_shape, imread, imread_bilevel_packed, imread_bin, imsave
from ..ops.threshold import binarize_into, otsu_threshold


@dataclass
class RawPage:
    """One corpus entry: raw image file, binarized file and line height.

    ``binary_path=None`` streams the page binary-free: the predictor
    binarizes the decoded image itself (its ``binarize`` mode), as the
    per-page path does when no binarized file exists."""

    image_path: str
    binary_path: Optional[str]
    line_height_px: int
    output_name: Optional[str] = None

    @property
    def name(self) -> str:
        return self.output_name or os.path.basename(self.image_path)


def pick_host_decimate(scale: float, cap: int = 8) -> int:
    """The largest decimation whose grid stays at or above the normalized
    grid (so the device resample only ever downsamples): floor(1 / scale),
    capped."""
    if scale <= 0:
        raise ValueError(f"scale must be positive, got {scale}")
    return max(1, min(cap, int(1.0 / scale)))


class RawCorpusPredictor:
    """Group raw pages by (shape, line height) and stream each group through
    a ThroughputPredictor on the classifier's device.

    ``classifier``: a PixelClassifier holding the model (any architecture;
    the RGB families normalize on the device in their own mode).
    ``window`` bounds host memory: at most two ``window``-sized slices of
    full-resolution pages are resident at once (the slice being predicted
    and the next one decoding on the prefetch thread).
    ``cc_vote`` is passed to the ThroughputPredictor as it is: True votes on
    the host in the finish stage, ``"pallas"`` on the card's CUDA labeler.
    ``int8`` (the grayscale FCNs) runs each group's int8 twin, calibrated on
    the group's first batch.
    """

    def __init__(
        self,
        classifier,
        palette: np.ndarray,
        target_line_height: int = 6,
        batch_size: int = 16,
        window: Optional[int] = None,
        download: str = "packed",
        cc_vote=False,
        int8: bool = False,
        compute_dtype=torch.bfloat16,
        binarize: str = "threshold",
        reuse_output_buffers: bool = False,
    ):
        if classifier.rgb and int8:
            raise ValueError("int8 supports the grayscale FCN families only")
        if binarize not in ("threshold", "otsu"):
            raise ValueError(f"binarize must be 'threshold' or 'otsu', got {binarize!r}")
        self.classifier = classifier
        self.palette = np.ascontiguousarray(palette, np.uint8)
        self.target_line_height = target_line_height
        self.batch_size = batch_size
        self.window = window or 4 * batch_size
        if download == "packed" and classifier.n_classes > 4:
            # the 2-bit packed download holds <= 4 classes
            download = "pred"
        self.download = download
        self.cc_vote = cc_vote
        self.int8 = int8
        # pages with binary_path=None: 'threshold' = global 128 (as
        # imread_bin), 'otsu' = per-page Otsu (strictly above t -> 255)
        self.binarize = binarize
        self.compute_dtype = compute_dtype
        # opt-in trio-buffer reuse (see ThroughputPredictor): a yielded trio
        # is then valid only until a few batches later
        self.reuse_output_buffers = bool(reuse_output_buffers)
        self._predictors = {}
        self._spare_ring: Optional[RawCorpusPredictor._SliceRing] = None
        # made here, not lazily: two threads could each install their own
        # lock and both pop the parked ring
        self._ring_lock = threading.Lock()

    # ------------------------------------------------------------- grouping
    def group(self, pages: Sequence[RawPage]):
        """[(key, members)] with key = (H, W, line_height_px); shapes come
        from the image headers (no full decode)."""
        groups = {}
        for page in pages:
            h, w = image_shape(page.image_path)
            groups.setdefault((h, w, page.line_height_px), []).append(page)
        return list(groups.items())

    def _predictor_for(self, key, packed_binary: bool = False):
        key = key + (packed_binary,)
        if key not in self._predictors:
            from .pipeline import ThroughputPredictor

            h, w, line_height, _ = key
            scale = self.target_line_height / line_height
            arch = self.classifier.architecture
            # the module already holds the classifier's weights: no state
            # dict to load (classifier.variables is the JAX-layout tree)
            self._predictors[key] = ThroughputPredictor(
                self.classifier.module,
                None,
                self.palette,
                (h, w),
                scale,
                host_decimate=pick_host_decimate(scale),
                stride_factor=arch.stride_factor,
                compute_dtype=self.compute_dtype,
                download=self.download,
                cc_vote=self.cc_vote,
                int8=self.int8,
                preprocess_mode=arch.preprocess_mode,
                packed_binary=packed_binary,
                reuse_output_buffers=self.reuse_output_buffers,
                device=self.classifier.device,
            )
        return self._predictors[key]

    # -------------------------------------------------------------- running
    class _SliceRing:
        """Two reusable (images, binaries) window buffer pairs: one being
        predicted, one being decoded into by the prefetch thread.  Fresh
        window-sized arrays for every slice would first-touch new memory
        each time, at page-fault speed.

        Each active run() holds a ring of its own, so two overlapping runs
        never hand each other's pixels out; a finished run parks its ring on
        the predictor for the next run() to reuse."""

        def __init__(self):
            self._pairs = [None, None]
            self._turn = 0

        def take(self, h: int, w: int, n: int, wb: Optional[int] = None):
            """(images (n, h, w), binaries (n, h, wb or w)): ``wb`` narrows
            the binary buffer to the packed-bit stride."""
            wb = w if wb is None else wb
            pair = self._pairs[self._turn % 2]
            if (pair is None or pair[0].shape[1:] != (h, w)
                    or pair[1].shape[1:] != (h, wb) or pair[0].shape[0] < n):
                pair = (np.empty((n, h, w), np.uint8), np.empty((n, h, wb), np.uint8))
                self._pairs[self._turn % 2] = pair
            self._turn += 1
            return pair[0][:n], pair[1][:n]

    def _take_ring(self) -> "RawCorpusPredictor._SliceRing":
        """Pop the parked ring (warm buffers) or make a fresh one; the caller
        owns it until _return_ring."""
        with self._ring_lock:
            ring, self._spare_ring = self._spare_ring, None
        return ring or self._SliceRing()

    def _return_ring(self, ring) -> None:
        """Park one ring for the next run(); a second one is dropped."""
        with self._ring_lock:
            if self._spare_ring is None:
                self._spare_ring = ring

    def _load_slice(self, ring, members: List[RawPage], h: int, w: int, packed: bool = False):
        images, binaries = ring.take(h, w, len(members), wb=(w + 7) // 8 if packed else None)

        def load(i_page: Tuple[int, RawPage]):
            i, page = i_page
            img = imread(page.image_path, as_gray=True)
            if img.shape != (h, w):
                raise ValueError(
                    f"{page.image_path}: shape {img.shape} changed between header probe "
                    f"and decode (expected {(h, w)})")
            images[i] = img
            if packed:
                # bit rows straight from the bilevel PNG
                got = imread_bilevel_packed(page.binary_path)
                if got is not None and got[0].shape[0] == h and got[1] == w:
                    binaries[i] = got[0]
                else:  # a binary that is not a bilevel filter-0 PNG
                    gray = imread(page.binary_path, as_gray=True)
                    binaries[i] = np.packbits(gray >= 128, axis=-1)
            elif page.binary_path is not None:
                # raw gray, not imread_bin's 0/255 rewrite: the ink gather's
                # `< 128` on raw gray equals `< 128` on the thresholded page
                binaries[i] = imread_bin(page.binary_path, binarize=False)
            elif self.binarize == "otsu":
                binarize_into(images[i], binaries[i], otsu_threshold(images[i]) + 1)
            else:
                binarize_into(images[i], binaries[i])

        if len(members) == 1:
            load((0, members[0]))
        else:
            # zlib and PIL release the GIL while they decode
            from ..data.dataset import io_pool

            list(io_pool().map(load, enumerate(members)))
        return images, binaries

    def run(self, pages: Sequence[RawPage], output_dir: Optional[str] = None):
        """Yield (RawPage, color, overlay, inverted) per page, writing the
        trio PNGs under ``output_dir``/{color,overlay,inverted} when given."""
        from concurrent.futures import ThreadPoolExecutor

        if output_dir:
            for sub in ("color", "overlay", "inverted"):
                os.makedirs(os.path.join(output_dir, sub), exist_ok=True)
        ring = self._take_ring()
        # packed-binary mode: every page has a binary file and the first one
        # reads as a bilevel filter-0 PNG; binaries then stay bit-packed
        # from disk to the ink gather
        pages = list(pages)
        packed = bool(pages) and all(p.binary_path for p in pages) and (
            imread_bilevel_packed(pages[0].binary_path) is not None)
        try:
            for (h, w, line_height), members in self.group(pages):
                predictor = self._predictor_for((h, w, line_height), packed_binary=packed)
                slices = [members[start : start + self.window]
                          for start in range(0, len(members), self.window)]
                # decode the next slice while the current one predicts
                with ThreadPoolExecutor(1) as loader:
                    pending = loader.submit(self._load_slice, ring, slices[0], h, w, packed)
                    for index, chunk in enumerate(slices):
                        images, binaries = pending.result()
                        if index + 1 < len(slices):
                            pending = loader.submit(
                                self._load_slice, ring, slices[index + 1], h, w, packed)
                        yield from self._run_slice(predictor, chunk, images, binaries, output_dir)
        finally:
            # runs when the generator is exhausted, closed or collected
            self._return_ring(ring)

    def _run_slice(self, predictor, chunk, images, binaries, output_dir):
        done = 0
        for color, overlay, inverted in predictor.run(images, binaries, batch_size=self.batch_size):
            for j in range(color.shape[0]):
                page = chunk[done + j]
                trio = (color[j], overlay[j], inverted[j])
                if output_dir:
                    for sub, mask in zip(("color", "overlay", "inverted"), trio):
                        imsave(os.path.join(output_dir, sub, page.name), mask)
                yield (page,) + trio
            done += color.shape[0]
