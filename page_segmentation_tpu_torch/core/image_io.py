"""Image reading and writing for the predict paths.

Counterpart of the part of ``page_segmentation_tpu/core/image_io.py`` that
the paths use: ``imread``, ``imread_rgb``, ``imread_bin``, ``encode_png``,
``imsave``, ``imsave_indexed``, the 1-bit pair ``imsave_bilevel`` /
``imread_bilevel_packed`` of the raw corpus's packed-binary mode, the
palette-index readers ``decode_labels_bytes`` / ``imread_labels`` of the
segmentation path, and ``random_indices``, ``glob_all``, ``split_filename``
and ``chunks`` of the dataset and segmentation tools.  The
writers need neither PIL nor cv2: PNGs are written here with filter-0 rows
through ``zlib`` (1-bit gray, 8-bit gray, 8-bit RGB, and indexed at the
smallest legal bit depth), and decode to the same pixels as the JAX
package's writers.  The readers decode such non-interlaced filter-0 PNGs
through ``zlib`` too (:func:`decode_png_unfiltered`) and hand every other
file to PIL, imported where it is needed; PIL's pixel contract holds either
way.
"""
from __future__ import annotations

import os
import struct
import zlib
from random import shuffle
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _pil_luma(rgb: np.ndarray) -> np.ndarray:
    """PIL's convert('L'): fixed-point ITU-R 601-2 luma with round-half-up."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _png_bytes(rows: np.ndarray, w: int, depth: int, color_type: int,
               palette: Optional[np.ndarray] = None, level: int = 1) -> bytes:
    """A non-interlaced PNG of packed ``rows`` (H, row bytes), each written
    with filter 0."""
    h = rows.shape[0]
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)
    raw[:, 1:] = rows
    out = [_PNG_MAGIC,
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0))]
    if palette is not None:
        out.append(_png_chunk(b"PLTE", np.ascontiguousarray(palette, np.uint8).tobytes()))
    out.append(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), level)))
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def _unpack_msb(packed: np.ndarray, w: int, depth: int) -> np.ndarray:
    """(H, row bytes) of sub-byte samples, MSB-first -> (H, w) uint8."""
    k = 8 // depth
    mask = np.uint8((1 << depth) - 1)
    expanded = np.empty((packed.shape[0], packed.shape[1] * k), np.uint8)
    for i in range(k):
        expanded[:, i::k] = (packed >> np.uint8((k - 1 - i) * depth)) & mask
    return np.ascontiguousarray(expanded[:, :w])


def _png_rows(data: bytes):
    """(header, palette, rows (H, row bytes)) of a non-interlaced PNG whose
    rows all carry filter 0, the filter bytes stripped; ``header`` is IHDR's
    (w, h, depth, color_type).  None for any other PNG, and for bytes that
    are not one (truncated or malformed input included)."""
    if len(data) < 8 or data[:8] != _PNG_MAGIC:
        return None
    pos, header, palette, idat = 8, None, None, []
    try:
        while pos + 8 <= len(data):
            (length,) = struct.unpack(">I", data[pos : pos + 4])
            tag, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
            pos += 12 + length
            if tag == b"IHDR":
                header = struct.unpack(">IIBBBBB", payload)
            elif tag == b"PLTE":
                palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            elif tag == b"IDAT":
                idat.append(payload)
            elif tag == b"IEND":
                break
        if header is None or not idat:
            return None
        w, h, depth, color_type, comp, filt, interlace = header
        if (comp, filt, interlace) != (0, 0, 0):
            return None
        channels = {0: 1, 2: 3, 3: 1}.get(color_type)
        allowed = {0: (1, 8), 2: (8,), 3: (1, 2, 4, 8)}.get(color_type, ())
        if channels is None or depth not in allowed or (color_type == 3 and palette is None):
            return None
        stride = (w * channels * depth + 7) // 8
        raw = zlib.decompress(b"".join(idat))
        if len(raw) != h * (stride + 1):
            return None
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    except (struct.error, zlib.error, ValueError):
        return None
    if rows[:, 0].any():  # filtered rows: not this decoder's
        return None
    return (w, h, depth, color_type), palette, rows[:, 1:]


def decode_png_unfiltered(data: bytes):
    """(pixels, palette) of a non-interlaced PNG whose rows all carry filter
    0: 8-bit gray (H, W), 1-bit gray expanded to 0/255, 8-bit RGB (H, W, 3),
    or indexed at depth 1/2/4/8 (labels (H, W) with its (n, 3) palette;
    palette None for the others).  None for any other PNG, and for bytes
    that are not one (truncated or malformed input included)."""
    got = _png_rows(data)
    if got is None:
        return None
    (w, h, depth, color_type), palette, rows = got
    if color_type == 2:
        return np.ascontiguousarray(rows).reshape(h, w, 3), None
    pixels = np.ascontiguousarray(rows[:, :w]) if depth == 8 else _unpack_msb(rows, w, depth)
    if color_type == 0:
        return (pixels * np.uint8(255) if depth == 1 else pixels), None
    return pixels, palette


def decode_image_bytes(data: bytes, as_gray: bool = False) -> np.ndarray:
    """Decode in-memory image bytes to uint8: (H, W) when ``as_gray``, else
    (H, W, 3) RGB; PIL's pixels for every format."""
    fast = decode_png_unfiltered(data)
    if fast is not None and fast[1] is not None and fast[0].size and fast[0].max() >= len(fast[1]):
        fast = None  # indices past the palette: PIL defines their color
    if fast is not None:
        pixels, palette = fast
        if palette is not None:
            pixels = palette[pixels]
        if pixels.ndim == 2:
            return pixels if as_gray else np.stack([pixels] * 3, axis=-1)
        return _pil_luma(pixels) if as_gray else pixels
    import io

    from PIL import Image

    Image.MAX_IMAGE_PIXELS = None  # large historical scans
    with Image.open(io.BytesIO(data)) as im:
        if as_gray:
            if im.mode not in ("L", "I;16", "I"):
                im = im.convert("L")
            arr = np.asarray(im)
            if arr.dtype == np.uint16:
                arr = (arr // 257).astype(np.uint8)
            elif arr.dtype != np.uint8:  # 32-bit 'I' mode and friends
                arr = np.clip(arr.astype(np.float64) / 257.0, 0, 255).astype(np.uint8)
            return arr
        return np.asarray(im.convert("RGB"))


def imread(path, as_gray: bool = False) -> np.ndarray:
    """Read an image as uint8; grayscale (H, W) when ``as_gray``."""
    with open(str(path), "rb") as f:
        return decode_image_bytes(f.read(), as_gray=as_gray)


def imread_rgb(path) -> np.ndarray:
    return imread(path, as_gray=False)


def image_shape(path) -> Tuple[int, int]:
    """(H, W) of an image from its header alone: a PNG's IHDR, or PIL's lazy
    open for other formats."""
    with open(str(path), "rb") as f:
        head = f.read(24)
    if head[:8] == _PNG_MAGIC and head[12:16] == b"IHDR":
        w, h = struct.unpack(">II", head[16:24])
        return h, w
    from PIL import Image

    with Image.open(path) as im:
        return im.height, im.width


def decode_labels_bytes(data: bytes) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(labels (H, W) uint8, palette (n, 3) uint8) of in-memory palette-mode
    PNG bytes; None for anything else (non-PNG, other color types,
    malformed input), so that the caller decodes the same bytes with
    :func:`decode_image_bytes`.  The pixels are PIL's: ``palette[labels]``
    is what PIL's ``convert('RGB')`` gives."""
    if len(data) < 8 or data[:8] != _PNG_MAGIC:
        return None
    fast = _decode_png_indexed_fast(data)
    if fast is not None:
        return fast
    import io

    try:
        from PIL import Image

        with Image.open(io.BytesIO(data)) as im:
            if im.mode != "P":
                return None
            labels = np.asarray(im)
            flat = im.getpalette()
    except Exception:  # malformed: the general decoder reports it
        return None
    if flat is None or len(flat) % 3:
        return None
    return labels, np.asarray(flat, np.uint8).reshape(-1, 3)


def _decode_png_indexed_fast(data) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(labels, palette) of a non-interlaced palette PNG at depth 1/2/4/8,
    straight from its zlib stream: inflate, the native unfilter for filtered
    rows, the native sub-byte unpack.  None for any other PNG and for
    malformed input."""
    from .. import native

    if isinstance(data, np.ndarray):
        data = data.tobytes()
    if len(data) < 8 or data[:8] != _PNG_MAGIC:
        return None
    try:
        pos, w, h, depth, plte, idat = 8, None, None, None, None, []
        while pos + 8 <= len(data):
            (length,) = struct.unpack(">I", data[pos : pos + 4])
            tag, payload = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + length]
            pos += 12 + length
            if tag == b"IHDR":
                w, h, depth, color_type, comp, filt, interlace = struct.unpack(">IIBBBBB", payload)
                if (color_type, comp, filt, interlace) != (3, 0, 0, 0) or depth not in (1, 2, 4, 8):
                    return None
            elif tag == b"PLTE":
                plte = payload
            elif tag == b"IDAT":
                idat.append(payload)
            elif tag == b"IEND":
                break
        if w is None or plte is None or not idat or len(plte) % 3 or not w or not h:
            return None
        stride = (w * depth + 7) // 8
        raw = zlib.decompress(b"".join(idat))
        if len(raw) != h * (stride + 1):
            return None
        rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
        palette = np.frombuffer(plte, np.uint8).reshape(-1, 3)
        if rows[:, 0].any():
            packed = native.png_unfilter(rows, bpp=1)
            if packed is None:
                return None
        else:
            packed = np.ascontiguousarray(rows[:, 1:])
        if depth == 8:
            return packed, palette
        return native.unpack_indices(packed, w, depth), palette
    except (struct.error, zlib.error, ValueError):
        return None


def imread_labels(path) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(labels, palette) of a palette-mode PNG file; None for any other
    file, which callers read through :func:`imread_rgb` (whose pixels are
    ``palette[labels]``)."""
    with open(str(path), "rb") as f:
        return decode_labels_bytes(f.read())


def imread_bin(path, binarize: bool = True, threshold: int = 128) -> np.ndarray:
    """Read a binarized image as 0/255 uint8 (white background, black ink)."""
    gray = imread(path, as_gray=True)
    if not binarize:
        return gray
    return np.where(gray >= threshold, np.uint8(255), np.uint8(0))


def _coerce_uint8(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype == bool:
        return image.astype(np.uint8) * 255
    if image.dtype != np.uint8:
        return np.clip(image, 0, 255).astype(np.uint8)
    return image


def encode_png(image: np.ndarray) -> bytes:
    """PNG bytes of a uint8 gray (H, W) or RGB (H, W, 3) array, filter-0
    rows at zlib level 1."""
    image = np.ascontiguousarray(_coerce_uint8(image))
    if image.ndim == 2:
        return _png_bytes(image, image.shape[1], 8, 0)
    if image.ndim == 3 and image.shape[2] == 3:
        return _png_bytes(image.reshape(image.shape[0], -1), image.shape[1], 8, 2)
    raise ValueError(f"encode_png takes (H, W) gray or (H, W, 3) RGB, got {image.shape}")


def imsave(path, image: np.ndarray) -> None:
    """Write an image; PNGs through :func:`encode_png`, other formats
    through PIL."""
    if str(path).lower().endswith(".png"):
        with open(str(path), "wb") as f:
            f.write(encode_png(image))
        return
    from PIL import Image

    Image.fromarray(_coerce_uint8(image)).save(path)


def imsave_gray_fast(path, image: np.ndarray, level: int = 1) -> None:
    """Write an (H, W) gray page as an 8-bit PNG of filter-0 rows at zlib
    ``level``: a single inflate reads it back, with no row unfiltering."""
    arr = _coerce_uint8(np.asarray(image))
    if arr.ndim != 2:
        raise ValueError(f"imsave_gray_fast takes (H, W) grayscale, got {arr.shape}")
    with open(str(path), "wb") as f:
        f.write(_png_bytes(np.ascontiguousarray(arr), arr.shape[1], 8, 0, level=level))


# the rows whose PIL filter is worked out at a time (bounds the candidates' memory)
_PIL_FILTER_BLOCK = 256


def _pil_filtered_rows(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PIL's PNG row filtering of (H, row bytes) uint8 samples: each row
    takes, of the filters none, up, sub and Paeth tried in that order, the
    first whose bytes (as signed) sum least in magnitude; PIL never picks
    the average filter.  Returns the (H, 1 + row bytes) filtered rows.

    A row of zeros takes none and a row equal to the one above takes up
    (their sums are 0), which settles most rows of a mask at once; the
    candidates are worked out for the other rows only."""
    h, n = rows.shape
    out = np.zeros((h, n + 1), np.uint8)
    zero = ~rows.any(axis=1)
    repeat = np.zeros(h, bool)
    repeat[1:] = (rows[1:] == rows[:-1]).all(axis=1)
    out[~zero & repeat, 0] = 2
    rest = np.flatnonzero(~zero & ~repeat)
    order = np.array([0, 2, 1, 4], np.uint8)
    for b0 in range(0, len(rest), _PIL_FILTER_BLOCK):
        idx = rest[b0:b0 + _PIL_FILTER_BLOCK]
        raw = rows[idx].astype(np.int16)
        up = np.where((idx > 0)[:, None], rows[np.maximum(idx - 1, 0)], 0).astype(np.int16)
        left = np.zeros_like(raw)
        left[:, bpp:] = raw[:, :-bpp]
        upleft = np.zeros_like(raw)
        upleft[:, bpp:] = up[:, :-bpp]
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        candidates = np.stack([raw, raw - up, raw - left, raw - paeth]).astype(np.uint8)
        sums = np.abs(candidates.view(np.int8).astype(np.int16)).sum(axis=2, dtype=np.int64)
        pick = sums.argmin(axis=0)
        out[idx, 0] = order[pick]
        out[idx, 1:] = candidates[pick, np.arange(len(idx))]
    return out


def encode_png_pil(image: np.ndarray) -> bytes:
    """The bytes of PIL's ``Image.save(format="PNG")`` of an 8-bit gray
    (H, W) or RGB (H, W, 3) array, made without PIL: PIL's row filters, zlib
    level 6 with memory level 9 and the filtered strategy, IDAT chunks of
    PIL's buffer size."""
    image = np.ascontiguousarray(_coerce_uint8(image))
    if image.ndim == 2:
        color_type, bpp = 0, 1
    elif image.ndim == 3 and image.shape[2] == 3:
        color_type, bpp = 2, 3
    else:
        raise ValueError(f"encode_png_pil takes (H, W) gray or (H, W, 3) RGB, got {image.shape}")
    h, w = image.shape[:2]
    filtered = _pil_filtered_rows(image.reshape(h, -1), bpp)
    deflate = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = deflate.compress(filtered.tobytes()) + deflate.flush()
    block = max(65536, w * 4)
    out = [_PNG_MAGIC,
           _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))]
    out += [_png_chunk(b"IDAT", data[i:i + block]) for i in range(0, len(data), block)]
    out.append(_png_chunk(b"IEND", b""))
    return b"".join(out)


def imsave_pil(path, image: np.ndarray) -> None:
    """Write an image with PIL's bytes, for files whose bytes are frozen or
    compared with PIL-written ones: gray and RGB PNGs through
    :func:`encode_png_pil`, which needs no PIL, anything else through PIL
    itself, which the card's machine lacks."""
    image = _coerce_uint8(image)
    if str(path).lower().endswith(".png") and (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        with open(str(path), "wb") as f:
            f.write(encode_png_pil(image))
        return
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(f"imsave_pil needs PIL (Pillow) for {path!r}, which is not installed; "
                          "gray and RGB PNGs need no PIL") from exc
    Image.fromarray(image).save(path)


def imsave_indexed(path, labels: np.ndarray, palette: np.ndarray) -> None:
    """Write a label map as an indexed PNG at the smallest legal bit depth;
    decoders recover ``palette[labels]``.  Non-uint8 labels and non-PNG
    paths are written as the RGB image instead."""
    labels = np.ascontiguousarray(labels)
    palette = np.asarray(palette, np.uint8)
    if labels.dtype != np.uint8 or not str(path).lower().endswith(".png"):
        imsave(path, palette[labels])
        return
    h, w = labels.shape
    n_entries = max(len(palette), int(labels.max()) + 1 if labels.size else 1)
    depth = next(d for d in (1, 2, 4, 8) if n_entries <= 1 << d)
    if depth == 8:
        packed = labels
    else:  # MSB-first, the PNG bit order
        k = 8 // depth
        padded = np.pad(labels, ((0, 0), (0, (-w) % k)))
        packed = np.zeros((h, padded.shape[1] // k), np.uint8)
        for i in range(k):
            packed |= padded[:, i::k] << np.uint8((k - 1 - i) * depth)
    with open(str(path), "wb") as f:
        f.write(_png_bytes(packed, w, depth, 3, palette=palette))


def imsave_bilevel(path, binary: np.ndarray) -> None:
    """Write a binarized page as a 1-bit gray PNG (nonzero -> white), rows
    MSB-first with filter 0 at zlib level 6: the layout whose rows
    :func:`imread_bilevel_packed` hands back without expanding them.  Any
    decoder reads it as 0/255."""
    arr = np.asarray(binary)
    with open(str(path), "wb") as f:
        f.write(_png_bytes(np.packbits(arr != 0, axis=-1), arr.shape[1], 1, 0, level=6))


def imread_bilevel_packed(path) -> Optional[Tuple[np.ndarray, int]]:
    """(packed rows (H, ceil(W/8)) uint8 MSB-first, W) of a 1-bit gray
    filter-0 PNG (the :func:`imsave_bilevel` layout); None for any other
    file, malformed or truncated ones included, which callers read through
    the expanding decoders.  Bit 1 is white paper and bit 0 ink, so ink is
    ``bit == 0``: the ``< 128`` contract on 0/255 pixels."""
    try:
        with open(str(path), "rb") as f:
            got = _png_rows(f.read())
    except OSError:
        return None
    if got is None or got[0][2:] != (1, 0):
        return None
    (w, _h, _depth, _color_type), _palette, rows = got
    return np.ascontiguousarray(rows), w


def random_indices(collection: Sequence) -> List[int]:
    """The indices of ``collection`` in an order drawn by the ``random``
    module, so that ``random.seed`` fixes it."""
    indices = list(range(len(collection)))
    shuffle(indices)
    return indices


def glob_all(patterns: Iterable[str]) -> List[str]:
    """Shell glob patterns expanded, each sorted; a pattern that matches
    nothing stays as it is."""
    import glob

    out: List[str] = []
    for pattern in patterns:
        matched = sorted(glob.glob(pattern))
        out.extend(matched if matched else [pattern])
    return out


def split_filename(path) -> Tuple[str, str, str]:
    """(directory, basename without its extension, extension) of a path."""
    directory, name = os.path.split(str(path))
    base, ext = os.path.splitext(name)
    return directory, base, ext.lstrip(".")


def chunks(items: Sequence, n: int) -> Iterable[Sequence]:
    """Successive slices of ``items`` of length ``n`` (the last may be
    shorter)."""
    for i in range(0, len(items), n):
        yield items[i : i + n]
