"""Training progress hooks and visual diagnostics.

Counterpart of ``page_segmentation_tpu/train/callbacks.py``: the embeddable
``TrainProgressCallback`` interface, ``ScalarLogger`` (one JSON line per
epoch in ``scalars.jsonl``), ``ModelDiagnoser`` (input, ground truth,
prediction and overlay PNGs per validation page and epoch) and
``TensorboardWriter``.  The card's machine has no TensorFlow, so the writer
keeps the JAX class's fallback only: images as PNG files, scalars left to
``ScalarLogger``.  PNGs are written by the port's own ``imsave``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Optional

import numpy as np

from ..core.colors import ColorMap
from ..core.image_io import imsave


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


class TensorboardWriter:
    """Image and scalar writer; without TensorFlow (always, in the port)
    images are written as ``<tag>-<counter>.png`` under ``outdir`` and
    scalars are dropped (``ScalarLogger`` keeps them)."""

    def __init__(self, outdir: str, max_outputs: int = 10):
        os.makedirs(outdir, exist_ok=True)
        self.outdir = outdir
        self.max_outputs = max_outputs
        self.counter = 0

    def save_image(self, tag: str, image: np.ndarray, global_step: Optional[int] = None) -> None:
        arr = np.asarray(image)
        if arr.ndim == 4:
            arr = arr[0]
        imsave(os.path.join(self.outdir, tag.replace("/", "_") + f"-{self.counter}.png"),
               np.clip(arr, 0, 255).astype(np.uint8))
        self.counter += 1

    def save_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def close(self) -> None:
        pass


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
