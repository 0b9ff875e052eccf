"""ctypes bindings for the host C functions of the predict, segmentation
and PageXML paths and of flax's fresh weights (``ps_native.cpp``).

The library is built with g++ at first use into the package's ``_build/``
directory (see ``_kernels.py``); a failed build raises.  Every wrapper
validates shapes, dtypes and contiguity before it passes a pointer.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional

import numpy as np

from .._kernels import LibrarySpec, _gxx, load_library

# -march=native, as the JAX package's Makefile: a build is for the machine
# that made it (_build/ is never copied between machines)
NATIVE_SPEC = LibrarySpec(
    "ps_native", _gxx,
    # -ffp-contract=off: the rasterizer's float crossings must round as PIL's
    ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared", "-ffp-contract=off"),
    ("native/ps_native.cpp",),
)

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
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
    "ps_contours": (_int, [_u8p, _int, _int, _i32p, _int, _i32p, _int]),
    "ps_bitmorph": (_int, [_u8p, _int, _int, _int, _int, _u8p]),
    "ps_bitmorph_chain": (_int, [_u8p, _int, _int, _int, _int, _int, _u8p]),
    "ps_png_unfilter": (_int, [_u8p, _int, _int, _int, _u8p]),
    "ps_pack_indices": (_int, [_u8p, _int, _int, _int, _u8p]),
    "ps_unpack_indices": (_int, [_u8p, _int, _int, _int, _int, _u8p]),
    "ps_fill_polygon": (_int, [_u8p, _int, _int, _int, _int, _i32p, _u8p]),
    "ps_draw_lines": (_int, [_u8p, _int, _int, _int, _int, _i32p, _u8p, _int]),
    "ps_flax_draw": (None, [ctypes.c_uint32, ctypes.c_uint32, _int, ctypes.c_float,
                            ctypes.c_int64, ctypes.c_int64, _f32p]),
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


def available() -> bool:
    """Whether the native library builds and loads here (a missing
    compiler is an ``OSError``, a failed build a ``RuntimeError``)."""
    try:
        get_lib()
    except (OSError, RuntimeError):
        return False
    return True


def flax_draw(key, law: int, scale: np.float32, start: int, out: np.ndarray) -> None:
    """flax's initializer values of the flat indices [start, start +
    out.size) of one kernel drawn from ``key`` (``models/flax_init.py``):
    law 0 glorot_uniform's uniform [-1, 1), law 1 lecun_normal's truncated
    normal, times ``scale``; written into the contiguous float32 ``out``."""
    if out.dtype != np.float32 or out.ndim != 1 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a contiguous 1-D float32 array, got {out.dtype} {out.shape}")
    if law not in (0, 1):
        raise ValueError(f"law must be 0 (glorot_uniform) or 1 (lecun_normal), got {law}")
    get_lib().ps_flax_draw(int(key[0]), int(key[1]), law, float(scale), int(start), out.size, out)


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



def _mask_u8(mask: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(np.asarray(mask), np.uint8)
    if m.ndim != 2 or not m.size:
        raise ValueError(f"mask must be a non-empty (H, W) array, got {m.shape}")
    return m


def bitmorph(mask: np.ndarray, k: int, erode: bool = False) -> np.ndarray:
    """One k x k dilate (or erode) of a binary (H, W) mask through the
    bit-packed sliding-window kernel, with cv2's borders; uint8 0/255."""
    m = _mask_u8(mask)
    if k < 1:
        raise ValueError(f"kernel size must be >= 1, got {k}")
    h, w = m.shape
    out = np.empty((h, w), np.uint8)
    get_lib().ps_bitmorph(m, h, w, int(k), int(bool(erode)), out)
    return out


def bitmorph_chain(mask: np.ndarray, k: int, k3: int, k11: int) -> np.ndarray:
    """The text-contours morphology chain close(k), open(k3), dilate(k11),
    close(k11) of a binary (H, W) mask; uint8 0/255."""
    m = _mask_u8(mask)
    if min(k, k3, k11) < 1:
        raise ValueError(f"kernel sizes must be >= 1, got {(k, k3, k11)}")
    h, w = m.shape
    out = np.empty((h, w), np.uint8)
    get_lib().ps_bitmorph_chain(m, h, w, int(k), int(k3), int(k11), out)
    return out


def png_unfilter(rows: np.ndarray, bpp: int = 1) -> Optional[np.ndarray]:
    """Reconstruct PNG-filtered rows (none/sub/up/average/paeth): ``rows``
    is the inflated stream as (h, stride + 1), a filter byte before each
    row; returns the (h, stride) bytes, or None for an invalid filter byte
    (a general decoder then reports the file)."""
    r = np.ascontiguousarray(np.asarray(rows), np.uint8)
    if r.ndim != 2 or r.shape[1] < 2 or not r.shape[0]:
        raise ValueError(f"rows must be (h, stride + 1) with stride >= 1, got {r.shape}")
    h, stride_p1 = r.shape
    out = np.empty((h, stride_p1 - 1), np.uint8)
    if get_lib().ps_png_unfilter(r, h, stride_p1 - 1, int(bpp), out) != 0:
        return None
    return out


def _check_depth(depth: int) -> int:
    if depth not in (1, 2, 4):
        raise ValueError(f"depth must be 1, 2 or 4, got {depth}")
    return 8 // depth


def pack_indices(labels: np.ndarray, depth: int) -> np.ndarray:
    """MSB-first sub-byte packing of a (H, W) uint8 label map into
    (H, ceil(W * depth / 8)) PNG index rows."""
    m = _mask_u8(labels)
    k = _check_depth(depth)
    if m.max() >= 1 << depth:
        raise ValueError(f"labels exceed depth {depth}")
    h, w = m.shape
    out = np.empty((h, (w + k - 1) // k), np.uint8)
    get_lib().ps_pack_indices(m, h, w, int(depth), out)
    return out


def unpack_indices(packed: np.ndarray, w: int, depth: int) -> np.ndarray:
    """Inverse of :func:`pack_indices`: (H, stride) rows -> (H, w) labels."""
    m = _mask_u8(packed)
    k = _check_depth(depth)
    h, stride = m.shape
    if not 0 < w <= stride * k:
        raise ValueError(f"w {w} does not fit rows of {stride} bytes at depth {depth}")
    out = np.empty((h, w), np.uint8)
    get_lib().ps_unpack_indices(m, h, stride, int(w), int(depth), out)
    return out


def contours(image: np.ndarray) -> List[np.ndarray]:
    """External contours (8-connectivity) of the nonzero pixels of one
    (H, W) image, as (N, 2) int32 (x, y) arrays in raster discovery order."""
    img = np.ascontiguousarray((np.asarray(image) != 0).astype(np.uint8))
    if img.ndim != 2:
        raise ValueError(f"image must be (H, W), got {img.shape}")
    h, w = img.shape
    max_points = h * w + 16
    max_contours = h * w // 4 + 16
    points = np.empty((max_points, 2), np.int32)
    lens = np.empty(max_contours, np.int32)
    n = get_lib().ps_contours(img, h, w, points, max_points, lens, max_contours)
    if n < 0:
        raise RuntimeError("ps_contours: output buffers overflowed")
    offsets = np.concatenate(([0], np.cumsum(lens[:n])))
    return [points[offsets[i] : offsets[i + 1]].copy() for i in range(n)]


def _canvas_args(canvas: np.ndarray, points, color):
    if canvas.dtype != np.uint8 or not canvas.flags.c_contiguous or canvas.ndim not in (2, 3):
        raise ValueError("canvas must be a C-contiguous uint8 (H, W) or (H, W, C) array")
    channels = 1 if canvas.ndim == 2 else canvas.shape[2]
    color = np.ascontiguousarray(np.broadcast_to(np.asarray(color, np.uint8).ravel(), (channels,)))
    xy = np.ascontiguousarray(np.asarray(points, np.int64).reshape(-1, 2))
    if xy.size and (np.abs(xy) > 1 << 28).any():
        raise ValueError("point coordinates out of range")
    return channels, xy.astype(np.int32), color


def fill_polygon(canvas: np.ndarray, points, color) -> None:
    """PIL's ``ImageDraw.polygon(points, fill=color)`` on ``canvas`` in
    place: (N, 2) integer (x, y) points, N >= 1."""
    channels, xy, color = _canvas_args(canvas, points, color)
    if not len(xy):
        raise ValueError("a polygon needs at least one point")
    h, w = canvas.shape[:2]
    get_lib().ps_fill_polygon(canvas.reshape(h, -1), h, w, channels, len(xy), xy, color)


def draw_lines(canvas: np.ndarray, points, color, width: int) -> None:
    """PIL's ``ImageDraw.line(points, fill=color, width=width)`` (no
    joints) on ``canvas`` in place."""
    channels, xy, color = _canvas_args(canvas, points, color)
    h, w = canvas.shape[:2]
    get_lib().ps_draw_lines(canvas.reshape(h, -1), h, w, channels, len(xy), xy, color, int(width))
