"""Dataset loading, with a thread pool over pages.

Counterpart of ``page_segmentation_tpu/data/loader.py`` ``DatasetLoader``:
prediction mode (image and binary), training mode (also the label mask,
read through the color map and nearest-resized to the prepared image), and
dataset JSON files (``load_data_from_json``).
"""
from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Iterable, List, Optional

import numpy as np

from ..core.colors import ColorMap
from ..core.image_io import image_shape, imread, imread_bin
from .dataset import Dataset, SingleData, read_dataset_json
from .prepare import prepare_images, prepare_mask, prepared_shape


class DatasetLoader:
    def __init__(
        self,
        target_line_height: int,
        color_map: ColorMap,
        prediction: bool = False,
        max_width: Optional[int] = None,
        resize_backend: str = "scipy",
        num_workers: int = 12,
        binarize: str = "threshold",
    ):
        if binarize not in ("threshold", "otsu"):
            raise ValueError(f"binarize must be 'threshold' or 'otsu', got {binarize!r}")
        self.target_line_height = target_line_height
        self.prediction = prediction
        self.color_map = color_map
        self.max_width = max_width
        self.resize_backend = resize_backend
        self.num_workers = num_workers
        # how pages without a binarized file are binarized: 'threshold' =
        # global 128 (as imread_bin), 'otsu' = per-page Otsu
        self.binarize = binarize

    def load_images(self, entry: SingleData) -> SingleData:
        img = entry.image if entry.image is not None else imread(entry.image_path, as_gray=True)
        original_shape = img.shape
        if entry.binary is not None:
            binary = entry.binary
        elif entry.binary_path is not None:
            binary = imread_bin(entry.binary_path, True)
        elif self.binarize == "otsu":
            from ..ops.threshold import otsu_binarize

            binary = otsu_binarize(img, invert=True)
        else:
            # the image itself, thresholded in memory (byte-equal to
            # imread_bin(image_path))
            binary = np.where(img >= 128, np.uint8(255), np.uint8(0))

        img, binary, orig_bin = prepare_images(
            img, binary, self.target_line_height, entry.line_height_px, self.max_width,
            keep_orig_bin=True, resize_backend=self.resize_backend,
        )
        if not self.prediction:
            if entry.mask is None and entry.mask_path is None:
                raise ValueError("training mode needs a mask or a mask_path on every entry")
            mask = entry.mask if entry.mask is not None else self.color_map.imread_labels(entry.mask_path)
            mask = prepare_mask(mask, img.shape)
            if mask.shape != img.shape:
                raise ValueError(f"mask shape {mask.shape} != prepared image shape {img.shape}")
            entry.mask = mask
        entry.binary = binary
        entry.orig_binary = orig_bin
        entry.image = img
        entry.original_shape = original_shape
        return entry

    def peek_prepared_shape(self, entry: SingleData):
        """The shape :meth:`load_images` would produce, from the image
        header alone (:func:`image_shape`)."""
        return prepared_shape(image_shape(entry.binary_path or entry.image_path),
                              self.target_line_height, entry.line_height_px, self.max_width)

    def load_lazy(self, entry: SingleData) -> SingleData:
        """Materialize a lazy entry into a shallow copy; the source keeps
        only its paths."""
        fresh = copy.copy(entry)
        fresh.loader = None
        return self.load_images(fresh)

    def load_data(self, entries: Iterable[SingleData], lazy: bool = False) -> Dataset:
        """Eager (default): load every page, ``num_workers`` at a time.
        ``lazy``: keep pixels on disk; entries carry their peeked prepared
        shape and a back-reference to this loader."""
        entries = list(entries)
        if lazy:
            pathless = [e for e in entries if e.image is None and e.image_path is None]
            if pathless:
                raise ValueError(
                    "lazy loading needs image_path on every entry "
                    f"({len(pathless)} in-memory entries given)"
                )
            for e in entries:
                if e.image is None:
                    e.prepared_shape = self.peek_prepared_shape(e)
                    e.loader = self
            return Dataset(entries, self.color_map)
        if self.num_workers <= 1 or len(entries) <= 1:
            out = [self.load_images(e) for e in entries]
        else:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                out = list(pool.map(self.load_images, entries))
        return Dataset(out, self.color_map)

    def load_data_from_json(self, files: List[str], split_type: str, lazy: bool = False) -> Dataset:
        """The entries of ``split_type`` in dataset JSON ``files``, loaded as
        :meth:`load_data` loads them."""
        return self.load_data(read_dataset_json(files, split_type), lazy=lazy)
