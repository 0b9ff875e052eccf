"""Training progress hooks and visual diagnostics.

Counterpart of ``page_segmentation_tpu/train/callbacks.py``: the embeddable
``TrainProgressCallback`` interface, ``ScalarLogger`` (one JSON line per
epoch in ``scalars.jsonl``), ``ModelDiagnoser`` (input, ground truth,
prediction and overlay PNGs per validation page and epoch) and
``TensorboardWriter``, which writes TensorBoard event files as the JAX
class does through ``tf.summary``, with neither TensorFlow nor protobuf:
TFRecord framing, ``Event`` protos encoded by hand, PNGs by the port's
own encoder.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from ..core.colors import ColorMap
from ..core.image_io import encode_png, imsave


class TrainProgressCallback:
    """No-op interface for embedding front ends."""

    def init(self, total_iters: int, early_stopping_iters: int) -> None:
        pass

    def update_loss(self, batch: int, loss: float, acc: float) -> None:
        pass

    def next_best(self, epoch: int, acc: float, n_best: int) -> None:
        pass


class ScalarLogger:
    """Append-only JSONL scalar log: one record per call of :meth:`log`."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "scalars.jsonl")
        self._f = open(self.path, "a")

    def log(self, **record) -> None:
        record.setdefault("time", time.time())
        self._f.write(json.dumps({k: _to_py(v) for k, v in record.items()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _to_py(v):
    if hasattr(v, "detach"):  # a tensor
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.generic, np.ndarray)):
        return np.asarray(v).item() if np.ndim(v) == 0 else np.asarray(v).tolist()
    return v


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC-32C (Castagnoli) of ``data``."""
    from ..native import crc32c

    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    """One TFRecord: the length, its masked CRC, the data, its masked CRC."""
    length = struct.pack("<Q", len(data))
    return (length + struct.pack("<I", masked_crc32c(length)) + data
            + struct.pack("<I", masked_crc32c(data)))


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1  # negative int64s as two's complement
    while True:
        bits, n = n & 0x7F, n >> 7
        out.append(bits | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(number: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes (a string or a nested
    message) length-delimited."""
    if isinstance(value, int):
        return _varint(number << 3) + _varint(value)
    return _varint(number << 3 | 2) + _varint(len(value)) + value


_DT_FLOAT, _DT_STRING = 1, 7  # tensorflow DataType


def _tensor_proto(dtype: int, dims, content: bytes = b"", strings=()) -> bytes:
    shape = b"".join(_field(2, _field(1, d)) for d in dims)  # TensorShapeProto.dim.size
    return (_field(1, dtype) + _field(2, shape) + (_field(4, content) if content else b"")
            + b"".join(_field(8, x) for x in strings))


def _event(step: int, wall_time: float, **fields) -> bytes:
    """An ``Event``: wall_time (1), step (2), file_version (3), summary (5),
    source_metadata (10) naming the writer (1)."""
    out = _varint(1 << 3 | 1) + struct.pack("<d", wall_time)
    if step:
        out += _field(2, step)
    if "file_version" in fields:
        out += _field(3, fields["file_version"].encode())
    if "summary" in fields:
        out += _field(5, fields["summary"])
    if "writer" in fields:
        out += _field(10, _field(1, fields["writer"].encode()))
    return out


def _summary(tag: str, plugin: str, tensor: bytes) -> bytes:
    """A ``Summary`` of one value: tag (1), tensor (8), metadata (9) whose
    plugin data (1) names the plugin (1) with empty (version 0) content."""
    metadata = _field(1, _field(1, plugin.encode()))
    return _field(1, _field(1, tag.encode()) + _field(8, tensor) + _field(9, metadata))


def _image_uint8(images: np.ndarray) -> np.ndarray:
    """``tf.image.convert_image_dtype(images, tf.uint8, saturate=True)``."""
    if images.dtype == np.uint8:
        return images
    if np.issubdtype(images.dtype, np.floating):
        return np.clip(images * images.dtype.type(255.5), 0, 255).astype(np.uint8)
    if not np.issubdtype(images.dtype, np.integer):
        raise TypeError(f"images of dtype {images.dtype} cannot be converted to uint8")
    scale_in = int(np.iinfo(images.dtype).max)
    if scale_in > 255:
        return np.clip(images // ((scale_in + 1) // 256), 0, 255).astype(np.uint8)
    return np.clip(images.astype(np.int64) * (256 // (scale_in + 1)), 0, 255).astype(np.uint8)


class TensorboardWriter:
    """TensorBoard image and scalar writer: one ``events.out.tfevents.*``
    file under ``outdir``, as ``tf.summary``'s file writer makes it.

    The file is TFRecords of ``Event`` protos, the first of them
    ``file_version: "brain.Event:2"``.  :meth:`save_scalar` writes
    ``tf.summary.scalar``'s float32 scalar tensor (plugin ``scalars``) at
    ``step``; :meth:`save_image` writes ``tf.summary.image``'s string tensor
    ``[width, height, png, ...]`` (plugin ``images``) of up to
    ``max_outputs`` of the ``[k, h, w, c]`` images at ``self.counter``,
    then advances it.  Events are written as they come; :meth:`close`
    flushes."""

    def __init__(self, outdir: str, max_outputs: int = 10):
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self.max_outputs = max_outputs
        self.counter = 0
        now = time.time()
        self.path = os.path.join(outdir, f"events.out.tfevents.{int(now):010d}."
                                         f"{socket.gethostname()}.{os.getpid()}.{id(self)}.v2")
        self._f = open(self.path, "wb")
        self._f.write(tfrecord(_event(0, now, file_version="brain.Event:2", writer=__name__)))

    def _write(self, step: int, summary: bytes) -> None:
        self._f.write(tfrecord(_event(int(step), time.time(), summary=summary)))

    def save_image(self, tag: str, image: np.ndarray, global_step: Optional[int] = None) -> None:
        images = np.asarray(image)
        if images.ndim != 4:
            raise ValueError(f"images must be [k, h, w, c], got shape {images.shape}")
        images = _image_uint8(images)
        pngs = [encode_png(im) for im in images[: self.max_outputs]]
        dims = [str(images.shape[2]).encode(), str(images.shape[1]).encode()]
        tensor = _tensor_proto(_DT_STRING, [len(pngs) + 2], strings=dims + pngs)
        self._write(self.counter, _summary(tag, "images", tensor))
        self.counter += 1

    def save_scalar(self, tag: str, value: float, step: int) -> None:
        tensor = _tensor_proto(_DT_FLOAT, [], content=np.float32(value).tobytes())
        self._write(step, _summary(tag, "scalars", tensor))

    def close(self) -> None:
        self._f.close()


class ModelDiagnoser:
    """Input / GT / prediction / overlay PNGs per sample and epoch."""

    def __init__(self, output_dir: str, color_map: ColorMap, max_samples: int = 10):
        self.output_dir = output_dir
        self.color_map = color_map
        self.max_samples = max_samples
        os.makedirs(output_dir, exist_ok=True)

    def diagnose(self, epoch: int, samples) -> None:
        """samples: iterable of (image, binary, mask_labels, pred_labels)."""
        for index, (image, binary, mask, pred) in enumerate(samples):
            if index >= self.max_samples:
                break
            base = os.path.join(self.output_dir, f"{index}-{epoch}")
            image2d = image[..., 0] if image.ndim == 3 else image
            imsave(base + "-input.png", np.clip(image2d, 0, 255).astype(np.uint8))
            imsave(base + "-gt.png", self.color_map.to_rgb_array(mask))
            color_mask = self.color_map.to_rgb_array(pred)
            imsave(base + "-prediction.png", color_mask)
            overlay = color_mask.copy()
            inv_binary = np.stack([binary] * 3, axis=-1)
            overlay[inv_binary == 0] = 0
            imsave(base + "-overlay.png", overlay)
