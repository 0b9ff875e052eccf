"""Prediction orchestration of the per-page library path.

Counterpart of ``page_segmentation_tpu/inference/predictor.py``:
``Prediction``, ``PredictSettings`` and ``Predictor`` with ``predict``,
``predict_single``, ``predict_masks``, ``save_prediction`` and the batched
``predict_dataset_fast``, which groups pages by bucket shape, runs each
batch through ``PixelClassifier.predict_batch_masks`` (with the device
cc-vote when the lone post-processor is the cc-majority vote) and yields
``(data, pred, color, overlay, inverted)`` per page.  With
``PredictSettings.band_rows`` a page taller than one band window forwards
in sequential row bands (``parallel/spatial.py`` ``banded_forward``); with
``n_devices > 1`` a page above ``spatial_threshold`` pixels forwards as row
bands across a device mesh with receptive-field halos
(``parallel/spatial.py`` ``spatial_forward``; the CPU counts as
``n_devices`` devices when the network runs there).  Both are exact, and
neither applies to EfficientNet, whose squeeze-excite pools over the page.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Generator, List, NamedTuple, Optional

import numpy as np

from ..core.colors import ColorMap
from ..data.dataset import Dataset, SingleData, entry_shape, materialize
from ..ops.pad import bucket_shape, pad_to
from ..utils import gray_to_rgb
from .classifier import PixelClassifier
from .output import Masks, generate_output_masks, output_data, scale_to_original_shape


class Prediction(NamedTuple):
    labels: np.ndarray
    probabilities: np.ndarray
    data: SingleData


@dataclass
class PredictSettings:
    network: Optional[str] = None
    output: Optional[str] = None
    high_res_output: bool = False
    color_map: Optional[ColorMap] = None
    n_classes: int = -1
    post_process: Optional[List[Callable[[np.ndarray, SingleData], np.ndarray]]] = None
    gpu_allow_growth: bool = False  # accepted for the API's sake
    compute_dtype: str = "float32"
    bucket_granularity: int = 1
    # fuse a lone cc-majority post-processor into the batched dispatch
    # (device labeler + histogram vote); None = on when the network runs on
    # a CUDA device
    device_post_process: Optional[bool] = None
    # the space-to-depth stem of fcn/fcn_skip (models/s2d.py): same
    # parameters, same arithmetic
    s2d_stem: bool = False
    # int8 post-training quantization of the batched path (models/quant.py;
    # fcn/fcn_skip), calibrated on the first batch; predict_single stays float
    int8: bool = False
    # n_devices > 1: pages above spatial_threshold pixels forward as row bands
    # across a device mesh with receptive-field halos (parallel/spatial.py)
    n_devices: Optional[int] = None
    spatial_threshold: int = 16_000_000
    # pages taller than band_rows + 2 * margin forward in sequential row
    # bands with receptive-field halos (parallel/spatial.py): exact, and the
    # peak device memory is one window's activations
    band_rows: Optional[int] = None


class Predictor:
    def __init__(self, settings: PredictSettings, network: Optional[PixelClassifier] = None,
                 device="cuda"):
        self.settings = settings
        self.network = network
        if not network:
            self.network = PixelClassifier(
                n_classes=settings.n_classes,
                model_path=os.path.abspath(settings.network),
                compute_dtype=settings.compute_dtype,
                bucket_granularity=settings.bucket_granularity,
                s2d_stem=settings.s2d_stem,
                int8=settings.int8,
                device=device,
            )
        if settings.output:
            for category in ("overlay", "color", "inverted"):
                os.makedirs(os.path.join(settings.output, category), exist_ok=True)
        self._spatial_mesh = None
        if settings.n_devices and settings.n_devices > 1:
            from ..parallel.mesh import make_mesh

            on_cpu = self.network.device.type == "cpu"
            self._spatial_mesh = make_mesh(settings.n_devices, devices="cpu" if on_cpu else None)

    def predict(self, dataset: Dataset) -> Generator[Prediction, None, None]:
        for data in dataset.data:
            yield self.predict_single(data)

    def _preprocessed_hwc(self, data: SingleData) -> np.ndarray:
        """The network's normalized (H, W, C) float32 page, unpadded (a gray
        page repeated to 3 channels for the RGB families)."""
        net = self.network
        image = gray_to_rgb(data.image) if net.rgb else data.image
        arr = np.asarray(net.preprocess(np.asarray(image, np.float32)), np.float32)
        return arr[..., None] if arr.ndim == 2 else arr

    def _use_spatial(self, data: SingleData) -> bool:
        """Split a page across the mesh only where banding is exact (not
        EfficientNet) and the page has more than ``spatial_threshold``
        pixels."""
        from ..parallel.spatial import DEFAULT_MARGINS

        if self._spatial_mesh is None or self.network.architecture.value not in DEFAULT_MARGINS:
            return False
        h, w = data.image.shape[:2]
        return h * w > self.settings.spatial_threshold

    def _spatial_single_data(self, data: SingleData):
        """(logit, prob, pred) of one page split row-wise across the mesh."""
        from scipy.special import softmax

        from ..parallel.spatial import DEFAULT_MARGINS, spatial_forward

        net = self.network
        logit = spatial_forward(net.module, self._preprocessed_hwc(data), self._spatial_mesh,
                                margin=DEFAULT_MARGINS[net.architecture.value],
                                stride_factor=net.architecture.stride_factor)
        return logit, softmax(logit, -1), np.argmax(logit, -1)

    def _use_banded(self, data: SingleData) -> bool:
        """Band a page only where banding is exact (not EfficientNet: its
        squeeze-excite pools over the whole page) and the page is taller
        than one window."""
        from ..parallel.spatial import DEFAULT_MARGINS

        margin = DEFAULT_MARGINS.get(self.network.architecture.value)
        if not self.settings.band_rows or margin is None:
            return False
        return data.image.shape[0] > self.settings.band_rows + 2 * margin

    def _banded_single_data(self, data: SingleData):
        """(logit, prob, pred) of one page forwarded in row bands."""
        from scipy.special import softmax

        from ..parallel.spatial import DEFAULT_MARGINS, banded_forward

        net = self.network
        logit = banded_forward(net.module, self._preprocessed_hwc(data),
                               band_rows=self.settings.band_rows,
                               margin=DEFAULT_MARGINS[net.architecture.value],
                               stride_factor=net.architecture.stride_factor)
        return logit, softmax(logit, -1), np.argmax(logit, -1)

    def predict_single(self, data: SingleData) -> Prediction:
        data = materialize([data])[0]  # a lazy entry -> a loaded copy
        if self._use_spatial(data):
            _, prob, pred = self._spatial_single_data(data)
        elif self._use_banded(data):
            _, prob, pred = self._banded_single_data(data)
        else:
            _, prob, pred = self.network.predict_single_data(data)
        if self.settings.high_res_output:
            data, pred = scale_to_original_shape(data, pred)
        for processor in self.settings.post_process or []:
            pred = processor(pred, data)
        return Prediction(pred, prob, data)

    def predict_masks(self, data: SingleData) -> Masks:
        prediction = self.predict_single(data)
        return generate_output_masks(prediction.data, prediction.labels, self.settings.color_map)

    def save_prediction(self, prediction: Prediction) -> None:
        output_data(self.settings.output, prediction.labels, prediction.data, self.settings.color_map)

    # ------------------------------------------------------------ fast path
    def predict_dataset_fast(self, dataset: Dataset, batch_size: int = 8,
                             write_output: bool = False):
        """Batched prediction: pages grouped by bucket shape, padded to
        (batch, H, W), one dispatch per batch, cropped back; yields
        (data, pred, color, overlay, inverted) per page."""
        from .postprocess import vote_connected_component_class

        color_map = self.settings.color_map or (dataset.color_map if dataset else None)
        palette = color_map.palette if color_map else np.zeros((self.network.n_classes, 3), np.uint8)

        post = self.settings.post_process or []
        device_vote = self.settings.device_post_process
        if device_vote is None:
            device_vote = self.network.device.type == "cuda"
        # high_res_output post-processes at the original scale, after the
        # upscale, where the vote at the prepared scale is not the same
        device_vote = (bool(device_vote) and post == [vote_connected_component_class]
                       and not self.settings.high_res_output)
        host_post = None if device_vote else (post or None)

        groups = {}
        for data in dataset.data:
            shape = bucket_shape(entry_shape(data), self.network.architecture.stride_factor,
                                 self.network.bucket_granularity)
            groups.setdefault(shape, []).append(data)

        for shape, members in groups.items():
            for start in range(0, len(members), batch_size):
                chunk = materialize(members[start : start + batch_size])
                n = len(chunk)
                # a ragged tail pads to the full batch (zero pages, cropped
                # below); a group smaller than a batch pads to a power of two
                n_padded = (batch_size if len(members) > batch_size
                            else min(batch_size, 1 << max(0, n - 1).bit_length()))
                images = np.zeros((n_padded,) + shape, dtype=np.uint8)
                binaries = np.zeros((n_padded,) + shape, dtype=np.uint8)
                for i, d in enumerate(chunk):
                    images[i] = pad_to(d.image, shape)
                    binaries[i] = pad_to(d.binary, shape)
                pred_h, (color_h, overlay_h, inverted_h) = self.network.predict_batch_masks(
                    images, binaries, palette, device_vote=device_vote)
                for i, d in enumerate(chunk):
                    h, w = d.image.shape[:2]
                    pred_i = pred_h[i, :h, :w]
                    if self.settings.high_res_output:
                        d, pred_i = scale_to_original_shape(d, pred_i)
                    if host_post or self.settings.high_res_output:
                        # the label map changed: rebuild the trio from it
                        for post_fn in host_post or []:
                            pred_i = post_fn(pred_i, d)
                        masks = generate_output_masks(d, pred_i, color_map)
                        result = (d, pred_i, masks.color, masks.overlay, masks.inverted_overlay)
                    else:
                        result = (d, pred_i, color_h[i, :h, :w], overlay_h[i, :h, :w],
                                  inverted_h[i, :h, :w])
                    if write_output and self.settings.output:
                        self._write_trio(d, pred_i, palette, result)
                    yield result

    def _write_trio(self, d: SingleData, pred: np.ndarray, palette: np.ndarray, result) -> None:
        """The color product as an indexed PNG of the final labels, overlay
        and inverted as RGB PNGs."""
        from ..core.image_io import imsave, imsave_indexed

        filename = d.output_path or os.path.basename(d.image_path or "page.png")
        out = self.settings.output
        imsave_indexed(os.path.join(out, "color", filename), pred, palette)
        imsave(os.path.join(out, "overlay", filename), result[3])
        imsave(os.path.join(out, "inverted", filename), result[4])
