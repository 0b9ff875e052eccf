"""Data-parallel prediction of a batch over a device mesh.

Counterpart of ``page_segmentation_tpu/parallel/executor.py``: the batch
splits across the mesh's ``data`` axis, each device forwards its shard with
its copy of the module (``train/steps.py`` ``make_forward_fn``), takes the
argmax, and the labels come back in batch order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..train.steps import make_forward_fn
from ..utils import gray_to_rgb
from .mesh import Mesh, shard_batch


class ParallelPredictor:
    """Batched data-parallel forward + argmax of a ``PixelClassifier``."""

    def __init__(self, classifier, mesh: Mesh, data_axis: str = "data"):
        self.classifier = classifier
        self.mesh = mesh
        self.data_axis = data_axis
        self._forward = make_forward_fn(classifier.module, mesh, data_axis)

    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """images: (N, H, W) uint8 prepared pages of one bucket shape.  A
        ragged batch pads with zero pages to a multiple of the data axis.
        Returns the labels (N, H, W) int64 on the host."""
        n_dev = len(self.mesh.axis_devices(self.data_axis))
        n = images.shape[0]
        pad = (-n) % n_dev
        if pad:
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        pixels = np.asarray(gray_to_rgb(images) if self.classifier.rgb and images.ndim == 3
                            else images, np.float32)
        x = np.asarray(self.classifier.preprocess(pixels), np.float32)
        if x.ndim == 3:
            x = x[..., None]
        sharded = shard_batch(self.mesh, {"x": x}, self.data_axis)["x"]
        logits = self._forward(None, sharded)
        with torch.inference_mode():
            pred = [shard.argmax(-1).cpu().numpy() for shard in logits]
        return np.concatenate(pred)[:n]
