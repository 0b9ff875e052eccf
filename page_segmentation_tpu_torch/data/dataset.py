"""The dataset model of the predict path.

Counterpart of ``SingleData``, ``Dataset``, ``entry_shape``, ``io_pool`` and
``materialize`` in ``page_segmentation_tpu/data/dataset.py``.  Directory
listing, dataset JSON and splits come with training.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np

from ..core.colors import ColorMap


@dataclass
class SingleData:
    """One page: image + binarized image + (for training) label mask."""

    image: Optional[np.ndarray] = None
    binary: Optional[np.ndarray] = None
    orig_binary: Optional[np.ndarray] = None
    mask: Optional[np.ndarray] = None
    image_path: Optional[str] = None
    binary_path: Optional[str] = None
    mask_path: Optional[str] = None
    line_height_px: Optional[int] = 1
    original_shape: Optional[Tuple[int, int]] = None
    output_path: Optional[str] = None
    user_data: Any = None
    # lazy entries: pixels stay on disk; the prepared shape is peeked from
    # the file header and ``loader`` materializes a copy when it is used
    prepared_shape: Optional[Tuple[int, int]] = None
    loader: Any = None


@dataclass
class Dataset:
    data: List[SingleData]
    color_map: ColorMap

    def __len__(self) -> int:
        return len(self.data)

    def __iter__(self):
        return iter(self.data)


def entry_shape(d: SingleData) -> Tuple[int, int]:
    """Prepared (H, W) of an entry: its loaded pixels', or the peeked shape
    of a lazy entry."""
    if d.image is not None:
        return tuple(d.image.shape[:2])
    if d.prepared_shape is not None:
        return tuple(d.prepared_shape)
    raise ValueError("dataset entry has neither pixels nor a prepared_shape")


_io_pool = None
_io_pool_lock = threading.Lock()


def io_pool() -> ThreadPoolExecutor:
    """The process's thread pool for page decode and IO, min(cores, 8)
    threads wide, made at first use."""
    global _io_pool
    with _io_pool_lock:
        if _io_pool is None:
            width = max(1, min(8, os.cpu_count() or 1))
            _io_pool = ThreadPoolExecutor(max_workers=width, thread_name_prefix="ps-io")
        return _io_pool


def materialize(samples: List[SingleData]) -> List[SingleData]:
    """Load any lazy entries into shallow copies (the sources stay
    path-only, so callers hold a batch of pages, not the corpus)."""
    if not any(d.image is None and d.loader is not None for d in samples):
        return samples

    def load(d):
        return d.loader.load_lazy(d) if d.image is None and d.loader is not None else d

    if len(samples) == 1:
        return [load(samples[0])]
    return list(io_pool().map(load, samples))
