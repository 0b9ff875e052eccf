"""ctypes bindings for the host C functions of the predict path
(``ps_native.cpp``).

The library is built with g++ at first use into the package's ``_build/``
directory (see ``_kernels.py``); a failed build raises.  Every wrapper
validates shapes, dtypes and contiguity before it passes a pointer.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .._kernels import LibrarySpec, _gxx, load_library

# -march=native, as the JAX package's Makefile: a build is for the machine
# that made it (_build/ is never copied between machines)
NATIVE_SPEC = LibrarySpec(
    "ps_native", _gxx,
    ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"),
    ("native/ps_native.cpp",),
)

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_int = ctypes.c_int

_SIGNATURES = {
    "ps_cc_with_stats": (_int, [_u8p, _int, _int, _int, _i32p, _i32p, _f64p, _int]),
    "ps_cc_vote": (_int, [_u8p, _int, _int, _int, _i32p]),
    "ps_decimate_u8": (None, [_u8p, _int, _int, _int, _int, _u8p]),
    "ps_gather_ink": (None, [_u8p, _int, _int, _int, _i32p, _int, _i32p, _int, _u8p]),
    "ps_finish": (None, [_u8p, _u8p, _u8p] + [_int] * 6 + [_u8p] * 3),
    "ps_finish_packed": (None, [_u8p, _u8p, _u8p] + [_int] * 6 + [_u8p] * 3),
    "ps_vote_finish_packed": (None, [_u8p, _u8p, _u8p] + [_int] * 7 + [_u8p] * 3),
}


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    lib = load_library(NATIVE_SPEC)
    if not getattr(lib, "_ps_typed", False):
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        lib._ps_typed = True
    return lib


def cc_with_stats(image: np.ndarray, connectivity: int = 4):
    """cv2.connectedComponentsWithStats of the nonzero pixels of one (H, W)
    image: (num_labels, int32 labels, (n, 5) int32 stats, (n, 2) float64
    centroids)."""
    if connectivity not in (4, 8):
        raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")
    img = np.ascontiguousarray((np.asarray(image) != 0).astype(np.uint8))
    if img.ndim != 2:
        raise ValueError(f"image must be (H, W), got {img.shape}")
    h, w = img.shape
    labels = np.empty((h, w), np.int32)
    # 4-connected components are at most ceil(h*w/2) (a checkerboard); an
    # 8-connected one is at least as large
    max_labels = h * w // 2 + 2
    stats = np.empty((max_labels, 5), np.int32)
    centroids = np.empty((max_labels, 2), np.float64)
    n = get_lib().ps_cc_with_stats(img, h, w, connectivity, labels, stats, centroids, max_labels)
    if n < 0:
        raise RuntimeError(f"ps_cc_with_stats: more than {max_labels} components")
    return n, labels, stats[:n].copy(), centroids[:n].copy()


def cc_vote(binary: np.ndarray, pred: np.ndarray, n_classes: int) -> np.ndarray:
    """Majority class per 4-connected ink component of one page: returns
    ``pred`` (int32 copy) with each component set to its majority class."""
    binary_u8 = np.ascontiguousarray((np.asarray(binary) != 0).astype(np.uint8))
    out = np.ascontiguousarray(np.asarray(pred), dtype=np.int32).copy()
    if binary_u8.ndim != 2 or out.shape != binary_u8.shape:
        raise ValueError(f"binary {binary_u8.shape} and pred {out.shape} must be one (H, W) page")
    if out.size and (out.min() < 0 or out.max() >= n_classes):
        raise ValueError(f"pred classes must lie in [0, {n_classes})")
    h, w = binary_u8.shape
    get_lib().ps_cc_vote(binary_u8, h, w, int(n_classes), out)
    return out


def decimate_u8(pages: np.ndarray, factor: int) -> np.ndarray:
    """Batch box-mean decimation of (N, H, W) uint8 pages."""
    pages = np.ascontiguousarray(pages, np.uint8)
    if pages.ndim != 3 or factor < 1:
        raise ValueError(f"pages must be (N, H, W) and factor >= 1, got {pages.shape}, {factor}")
    n, h, w = pages.shape
    out = np.empty((n, h // factor, w // factor), np.uint8)
    get_lib().ps_decimate_u8(pages, n, h, w, int(factor), out)
    return out


def gather_ink(binaries: np.ndarray, row_idx: np.ndarray, col_idx: np.ndarray) -> np.ndarray:
    """Ink mask (binary < 128) nearest-gathered at (row_idx, col_idx)."""
    binaries = np.ascontiguousarray(binaries, np.uint8)
    row_idx = np.ascontiguousarray(row_idx, np.int32)
    col_idx = np.ascontiguousarray(col_idx, np.int32)
    if binaries.ndim != 3:
        raise ValueError(f"binaries must be (N, H, W), got {binaries.shape}")
    n, h, w = binaries.shape
    if row_idx.size and not (0 <= row_idx.min() and row_idx.max() < h):
        raise ValueError("row_idx out of range")
    if col_idx.size and not (0 <= col_idx.min() and col_idx.max() < w):
        raise ValueError("col_idx out of range")
    out = np.empty((n, len(row_idx), len(col_idx)), np.uint8)
    get_lib().ps_gather_ink(binaries, n, h, w, row_idx, len(row_idx), col_idx, len(col_idx), out)
    return out


def _finish_out(n: int, oh: int, ow: int, out):
    """Allocate the trio, or validate caller-supplied reusable buffers."""
    if out is None:
        color = np.empty((n, oh, ow, 3), np.uint8)
        return color, np.empty_like(color), np.empty_like(color)
    color, overlay, inverted = out
    expected = (n, oh, ow, 3)
    for arr in (color, overlay, inverted):
        if arr.shape != expected or arr.dtype != np.uint8 or not arr.flags.c_contiguous:
            raise ValueError(f"out buffers must be C-contiguous uint8 {expected}")
    return color, overlay, inverted


def _finish_inputs(classes: np.ndarray, ink: np.ndarray, palette: np.ndarray,
                   pixels_per_byte: int):
    classes = np.ascontiguousarray(classes, np.uint8)
    ink = np.ascontiguousarray(ink, np.uint8)
    palette = np.ascontiguousarray(palette, np.uint8)
    if classes.ndim != 3 or ink.ndim != 3 or palette.ndim != 2 or palette.shape[1] != 3:
        raise ValueError("classes/ink must be (N, H, W) and palette (C, 3)")
    n, ph, pw = classes.shape
    oh, ow = ink.shape[1:]
    if pw * pixels_per_byte < ow:
        raise ValueError(f"class rows cover {pw * pixels_per_byte} pixels < ow {ow}")
    if ph < oh:
        raise ValueError(f"class map height {ph} < ink height {oh}")
    if ink.shape[0] < n:
        raise ValueError(f"ink has {ink.shape[0]} pages < class map {n}")
    return classes, ink, palette


def finish_masks(pred: np.ndarray, ink: np.ndarray, palette: np.ndarray, out=None):
    """color/overlay/inverted from a (padded) uint8 class map and the ink
    mask, cropped to the ink's shape."""
    pred, ink, palette = _finish_inputs(pred, ink, palette, 1)
    n, ph, pw = pred.shape
    oh, ow = ink.shape[1:]
    color, overlay, inverted = _finish_out(n, oh, ow, out)
    get_lib().ps_finish(pred, ink, palette, palette.shape[0], n, ph, pw, oh, ow,
                        color, overlay, inverted)
    return color, overlay, inverted


def finish_masks_packed(packed: np.ndarray, ink: np.ndarray, palette: np.ndarray, out=None):
    """finish_masks reading the 2-bit packed class map (4 pixels/byte,
    LSB-first — output.unpack_classes layout) directly."""
    packed, ink, palette = _finish_inputs(packed, ink, palette, 4)
    n, ph, pw = packed.shape
    oh, ow = ink.shape[1:]
    color, overlay, inverted = _finish_out(n, oh, ow, out)
    get_lib().ps_finish_packed(packed, ink, palette, palette.shape[0], n, ph, pw, oh, ow,
                               color, overlay, inverted)
    return color, overlay, inverted


def vote_finish_packed(packed: np.ndarray, ink: np.ndarray, palette: np.ndarray,
                       n_classes: int, out=None):
    """The host cc-vote finish in one GIL-free call: unpack the 2-bit class
    map, majority-vote each 4-connected ink component, render the trio."""
    packed, ink, palette = _finish_inputs(packed, ink, palette, 4)
    n, ph, pw = packed.shape
    oh, ow = ink.shape[1:]
    color, overlay, inverted = _finish_out(n, oh, ow, out)
    get_lib().ps_vote_finish_packed(packed, ink, palette, palette.shape[0],
                                    int(n_classes), n, ph, pw, oh, ow,
                                    color, overlay, inverted)
    return color, overlay, inverted

