"""Pipelined multi-page segmentation (the ``page-segmentation`` command).

Counterpart of the JAX package's ``segmentation.batch``.  The reference
segments page after page on the host: decode the prediction PNG,
morphology, contours, render.  Here the same stage runs as a small
pipeline:

* decode-ahead: a prefetch thread decodes batch i+1 while batch i runs;
* indexed fast path: predictions written as palette PNGs
  (``core.image_io.imsave_indexed``) decode to their indices
  (``decode_labels_bytes``) and label selection becomes a byte compare
  (``find_segments_indexed``);
* device morphology: in ``--text_contours`` mode with ``backend="device"``
  the char-height-sized chain runs for a whole batch on the card
  (``device_morph.TextRegionMorphDevice``), 1-bit masks each way.

Every path writes the same files as the per-page host loop.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.colors import ColorMap, exact_color_mask
from ..core.image_io import split_filename
from .pc_segmentation import (
    find_segments,
    find_segments_indexed,
    get_text_contours_batch,
)
from .render import render_morphological, render_regions, render_xycut


class PageSegmenter:
    """Segment prediction PNGs into region masks (+ optional PAGE-XML).

    ``backend`` places the text-contours morphology: "host" (and "auto",
    the JAX package's default, which means host there too) runs the native
    bit-packed chain (``native.bitmorph_chain``) page by page; "device"
    runs the batched torch chain on ``device`` and raises where that
    device is missing, never falling back to the host.  XY-cut mode is
    always host.
    """

    def __init__(
        self,
        color_map: ColorMap,
        resize_height: int,
        text_contours: bool,
        output_dir: str,
        extension: str = "png",
        xml_output_dir: Optional[str] = None,
        backend: str = "auto",
        batch_size: int = 8,
        device="cuda",
    ):
        self.color_map = color_map
        self.resize_height = resize_height
        self.text_contours = text_contours
        self.output_dir = output_dir
        self.extension = extension
        self.xml_output_dir = xml_output_dir
        self.batch_size = max(1, int(batch_size))
        if backend not in ("auto", "host", "device"):
            raise ValueError(f"backend must be auto, host or device, got {backend!r}")
        self._device = None
        if backend == "device":
            from ..device import resolve_device
            from .device_morph import TextRegionMorphDevice

            resolve_device(device)
            if text_contours:
                self._device = TextRegionMorphDevice(device)

    # ------------------------------------------------------------- per page
    def _load(self, path: str):
        # one file read: the indexed decode, else the RGB decode of the
        # same bytes
        from ..core.image_io import decode_image_bytes, decode_labels_bytes

        with open(path, "rb") as f:
            data = f.read()
        got = decode_labels_bytes(data)
        if got is not None:
            labels, palette = got
            return path, None, labels, palette
        return path, decode_image_bytes(data), None, None

    def _text_mask(self, image, labels, palette) -> np.ndarray:
        text = np.asarray(self.color_map.color_for_label("text"), np.uint8)
        if labels is not None:
            idxs = np.flatnonzero((palette == text).all(axis=1))
            if len(idxs) == 0:
                return np.zeros(labels.shape, bool)
            if len(idxs) == 1:
                return labels == idxs[0]
            # exact-color semantics: every palette slot holding the text
            # color counts (degenerate palettes can repeat colors)
            return np.isin(labels, idxs)
        return exact_color_mask(image, tuple(int(c) for c in text)) > 0

    def _segments(self, image, labels, palette, char_height: int):
        if labels is not None:
            return find_segments_indexed(
                labels.shape[0], labels, palette, char_height,
                self.resize_height, self.color_map,
                only_images=self.text_contours,
            )
        return find_segments(
            image.shape[0], image, char_height, self.resize_height,
            self.color_map, only_images=self.text_contours,
        )

    # ------------------------------------------------------------ per batch
    def _start_batch(self, loaded, chs: List[int]):
        """Begin a batch: in text-contours mode on the device backend,
        enqueue its morphology now, so that the device works while the
        previous batch's contours and renders are made on the host."""
        masks = handles = None
        if self.text_contours:
            masks = [self._text_mask(img, lab, pal)
                     for (_, img, lab, pal) in loaded]
            if self._device is not None:
                from .device_morph import morph_kernels

                # one dispatch per page shape; mixed char heights share it
                handles = []
                groups = {}
                for i, mask in enumerate(masks):
                    groups.setdefault(mask.shape, []).append(i)
                for idxs in groups.values():
                    handles.append((idxs, self._device.dispatch(
                        np.stack([masks[i] for i in idxs]),
                        [morph_kernels(chs[i]) for i in idxs])))
        return loaded, chs, masks, handles

    def _finish_batch(self, started):
        loaded, chs, masks, handles = started
        contours: List[Optional[list]] = [None] * len(loaded)
        if self.text_contours:
            if handles is not None:
                from .pc_segmentation import contours_from_region_mask

                for idxs, handle in handles:
                    regions = self._device.collect(handle)  # uint8 0/255
                    for j, i in enumerate(idxs):
                        contours[i] = contours_from_region_mask(regions[j])
            else:
                # the host chain runs page by page on the mask list
                contours = get_text_contours_batch(masks, chs)
        for idx, (path, img, lab, pal) in enumerate(loaded):
            texts, images = self._segments(img, lab, pal, chs[idx])
            shape = img.shape[:2] if img is not None else lab.shape[:2]
            yield (path,) + tuple(
                self._finish_page(path, shape, texts, images, contours[idx]))

    def _finish_page(self, path, shape, segments_text, segments_image, contours):
        if self.text_contours:
            regions, method = contours, render_morphological
        else:
            regions, method = segments_text, render_xycut
        render_regions(
            self.output_dir, self.extension, shape, path, self.color_map,
            method, regions, segments_image,
        )
        if self.xml_output_dir:
            from ..pagexml.xml_gen import save_pagexml

            os.makedirs(self.xml_output_dir, exist_ok=True)
            page_name = split_filename(path)[1]
            save_pagexml(
                os.path.join(self.xml_output_dir, page_name + ".xml"),
                os.path.basename(path),
                shape,
                text_regions=regions,
                image_regions=segments_image,
            )
        return regions, segments_image

    # ----------------------------------------------------------------- run
    def run(self, pages: Sequence[Tuple[str, int]]):
        """Process [(prediction_path, char_height), ...]; yields
        (path, regions, image_segments) per page, in order.

        Three-way overlap: the prefetch thread decodes batch i+1, the
        device runs batch i's morphology (enqueued before batch i-1 is
        finished), and the main thread finishes batch i-1 (download,
        contours, render)."""
        pages = list(pages)
        batches = [pages[i : i + self.batch_size]
                   for i in range(0, len(pages), self.batch_size)]
        if not batches:
            return
        with ThreadPoolExecutor(1) as prefetch:

            def load_batch(batch):
                return [self._load(path) for path, _ in batch]

            pending = prefetch.submit(load_batch, batches[0])
            started_prev = None
            for i, batch in enumerate(batches):
                loaded = pending.result()
                if i + 1 < len(batches):
                    pending = prefetch.submit(load_batch, batches[i + 1])
                started = self._start_batch(loaded, [ch for _, ch in batch])
                if started_prev is not None:
                    yield from self._finish_batch(started_prev)
                started_prev = started
            yield from self._finish_batch(started_prev)
