"""The dataset model, directory walking and splits.

Counterpart of ``page_segmentation_tpu/data/dataset.py``: ``SingleData``,
``Dataset``, ``entry_shape``, ``io_pool`` and ``materialize``, and for
training ``list_dataset`` (a dataset directory -> page entries),
``read_dataset_json`` (the ``create-dataset-file`` JSON -> entries),
``single_split`` and ``create_splits``.  The splits draw from the ``random``
module as the JAX package does, so one ``random.seed`` gives the same splits
in both packages.
"""
from __future__ import annotations

import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from random import shuffle
from typing import Any, List, Optional, Tuple

import numpy as np

from ..core.colors import ColorMap
from ..core.image_io import random_indices


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


def _stem(path: str) -> str:
    """The file name up to its first dot: the page id that ties the binary,
    image and mask directories together."""
    return os.path.basename(path).split(".")[0]


def _scan_dir(directory: str, keep=None) -> List[str]:
    """Sorted full paths of a directory's files, optionally filtered."""
    if not os.path.exists(directory):
        raise Exception(f"Dataset dir does not exist at '{directory}'")
    names = sorted(os.listdir(directory))
    if keep is not None:
        names = [n for n in names if keep(n)]
    return [os.path.join(directory, n) for n in names]


def list_dataset(
    root_dir: str,
    line_height_px: Optional[int] = None,
    binary_dir_: str = "binary_images",
    images_dir_: str = "images",
    masks_dir_: str = "masks",
    masks_postfix: str = "",
    normalizations_dir: str = "normalizations",
    verify_filenames: bool = False,
) -> List[dict]:
    """A dataset directory as page-entry dicts.

    Three sibling directories of equal-length sorted file lists (binary,
    image, color mask; the mask recognized by ``masks_postfix``), and either
    a fixed ``line_height_px`` or per-page ``{"char_height": N}`` JSONs under
    ``normalizations/``.  With ``verify_filenames`` the pages are joined on
    the file-name stem, unmatched files dropped, and the normalization files
    matched per stem.
    """
    if not os.path.exists(root_dir):
        raise Exception(f"Dataset dir does not exist at '{root_dir}'")

    columns = {
        "binary_path": _scan_dir(os.path.join(root_dir, binary_dir_)),
        "image_path": _scan_dir(
            os.path.join(root_dir, images_dir_),
            keep=(lambda n: not n.endswith(masks_postfix)) if masks_postfix else None,
        ),
        "mask_path": _scan_dir(
            os.path.join(root_dir, masks_dir_),
            keep=(lambda n: n.endswith(masks_postfix)) if masks_postfix else None,
        ),
    }

    if verify_filenames:
        # join on stems; masks may carry the postfix after the stem's dot
        def keyed(paths, strip_postfix=""):
            out = {}
            for p in paths:
                body = p[: -len(strip_postfix)] if strip_postfix and p.endswith(strip_postfix) else p
                out[_stem(body)] = p
            return out

        maps = {
            col: keyed(paths, masks_postfix if col == "mask_path" else "")
            for col, paths in columns.items()
        }
        shared = sorted(set.intersection(*(set(m) for m in maps.values())))
        columns = {col: [m[s] for s in shared] for col, m in maps.items()}

    lengths = {col: len(paths) for col, paths in columns.items()}
    if len(set(lengths.values())) != 1:
        raise Exception(
            "Mismatch in dataset files length: %d, %d, %d!"
            % (lengths["binary_path"], lengths["image_path"], lengths["mask_path"])
        )
    n_pages = lengths["mask_path"]

    if line_height_px:
        heights = [line_height_px] * n_pages
    else:
        norm_dir = os.path.join(root_dir, normalizations_dir)
        if not os.path.exists(norm_dir):
            raise Exception(f"Norm dir does not exist at '{norm_dir}'")

        def char_height_of(path):
            with open(path, "r") as f:
                return json.load(f)["char_height"]

        norm_files = _scan_dir(norm_dir)
        if verify_filenames:
            # per joined page stem: pages the join dropped add no files
            by_stem = {_stem(p): p for p in norm_files}
            joined = [_stem(b) for b in columns["binary_path"]]
            missing = [s for s in joined if s not in by_stem]
            if missing:
                raise Exception(f"No normalization files for pages: {missing}")
            norm_files = [by_stem[s] for s in joined]
        heights = [char_height_of(p) for p in norm_files]
        if len(heights) != n_pages:
            raise Exception(
                f"{len(heights)} normalization files for {n_pages} pages in {norm_dir}"
            )

    return [
        {"binary_path": b, "image_path": i, "mask_path": m, "line_height_px": h}
        for b, i, m, h in zip(
            columns["binary_path"], columns["image_path"], columns["mask_path"], heights
        )
    ]


def read_dataset_json(files, split_type: str) -> List[SingleData]:
    """The entries of one split (``"all"``: train, test and eval) of dataset
    JSON files."""
    entries: List[SingleData] = []
    for path in files:
        with open(path, "r") as f:
            content = json.load(f)
        if split_type == "all":
            for t in ("train", "test", "eval"):
                entries += [SingleData(**d) for d in content.get(t, [])]
        else:
            entries += [SingleData(**d) for d in content[split_type]]
    return entries


def _resolve_split_sizes(requests: dict, total: int) -> dict:
    """Per-split size requests as absolute counts.

    A request is an absolute count, a fraction in (0, 1) of ``total``, or
    negative for "all files the others do not claim" (at most one split may
    ask for the remainder).  Raises if the counts exceed ``total``.
    """
    counts = {
        name: int(req * total) if 0 < req < 1 else int(req)
        for name, req in requests.items()
    }
    remainder_splits = [name for name, c in counts.items() if c < 0]
    if len(remainder_splits) > 1:
        raise Exception("At most one split may claim the remaining files")
    if remainder_splits:
        claimed = sum(c for c in counts.values() if c >= 0)
        counts[remainder_splits[0]] = total - claimed
    if sum(counts.values()) > total:
        detail = " + ".join(f"{name}={c}" for name, c in counts.items())
        raise Exception(
            f"Split sizes exceed the dataset: {detail} "
            f"sums to {sum(counts.values())} but only {total} files exist"
        )
    return counts


def single_split(n_train, n_test, n_eval, data_files):
    """A random three-way split, ``(train, test, eval)``, drawn without
    replacement; sizes as :func:`_resolve_split_sizes` reads them."""
    counts = _resolve_split_sizes(
        {"eval": n_eval, "train": n_train, "test": n_test}, len(data_files)
    )
    order = iter(random_indices(data_files))
    drawn = {
        name: [data_files[next(order)] for _ in range(counts[name])]
        for name in ("eval", "train", "test")
    }
    return drawn["train"], drawn["test"], drawn["eval"]


def create_splits(data_files: List[str], num_splits: int):
    """k-fold cross-validation: yields ``(rest, fold)`` per fold; the folds
    partition a shuffled copy of the file list."""
    pool = data_files.copy()
    shuffle(pool)
    fold_indices = np.array_split(np.arange(len(pool)), num_splits)
    for held_out in fold_indices:
        keep = set(held_out.tolist())
        fold = [pool[i] for i in held_out]
        rest = [f for i, f in enumerate(pool) if i not in keep]
        yield rest, fold
