"""The network runtime of the per-page predict path: model build and load,
the single-page forward, and the batched forward with the device vote.

Counterpart of ``page_segmentation_tpu/inference/classifier.py``
``PixelClassifier``.  Pages are padded bottom/right to a bucketed shape (a
multiple of the architecture's stride factor) before the forward and the
logits cropped back exactly.  PyTorch runs eagerly, so there is no
per-shape compile cache: one module, in eval mode, under
``torch.inference_mode()``.

``int8=True`` (fcn/fcn_skip) runs the batched path (``predict_batch_masks``)
through the int8 twin (``models/quant.py``), calibrated in float32 on the
first batch it sees; ``predict_single_data`` stays float, as in the JAX
package.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.dataset import SingleData
from ..device import resolve_device
from ..models.bridge import init_variables, params_from_jax
from ..models.registry import Architecture
from ..ops.pad import bucket_shape, crop_to, pad_to
from ..utils import gray_to_rgb

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PixelClassifier:
    """A torch module and its weights, serving the single-page and batched
    forwards on ``device``.

    ``variables`` (and ``params``) hold the weights in the JAX package's
    layout, ``{"params": ..., "batch_stats": ...}`` of numpy arrays
    (``batch_stats`` for the BatchNorm families); setting either loads them
    into the module.  Without ``model_path`` the weights are
    ``models/bridge.py`` ``init_variables(module, seed)``: the JAX
    package's fresh weights for FCNSkip and FCN, numpy's draws under
    flax's law for the other models.  ``model_path`` is a
    checkpoint directory or a Keras ``.h5`` (read with h5py).
    """

    def __init__(
        self,
        n_classes: int,
        architecture: Architecture = Architecture.FCN_SKIP,
        model_path: Optional[str] = None,
        compute_dtype=torch.float32,
        bucket_granularity: int = 1,
        seed: int = 0,
        s2d_stem: bool = False,
        int8: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.n_classes = n_classes
        self.compute_dtype = _DTYPES.get(compute_dtype, compute_dtype)
        self.bucket_granularity = bucket_granularity
        self.s2d_stem = s2d_stem
        self.int8 = bool(int8)
        self._int8_twin = None  # built at the first int8 batch
        self._amax = None  # the twin's calibrated ranges (JAX amax layout)
        self._variables = None
        self._rebuild(architecture)
        if model_path:
            self.load(model_path)
        else:
            self.init_params(seed)

    # ----------------------------------------------------------- properties
    @property
    def variables(self):
        return self._variables

    @variables.setter
    def variables(self, value):
        if "params" not in value:
            value = {"params": value}
        self.module.load_state_dict(params_from_jax(value))
        self._variables = dict(value)
        self._int8_twin = self._amax = None  # new weights: recalibrate

    @property
    def params(self):
        return self._variables["params"]

    @params.setter
    def params(self, value):
        self.variables = {**(self._variables or {}), "params": value}

    @property
    def model_state(self):
        """The collections besides ``params``: ``batch_stats`` for the
        BatchNorm families, {} for the others."""
        return {k: v for k, v in (self._variables or {}).items() if k != "params"}

    @property
    def amax(self):
        """The int8 twin's calibrated ranges (the JAX package's ``amax``
        collection), None until the first int8 batch; setting them skips
        the calibration."""
        return self._amax

    @amax.setter
    def amax(self, value):
        from ..models.bridge import amax_from_jax

        amax_from_jax(self._twin(), value)
        self._amax = value

    def _twin(self):
        if self._int8_twin is None:
            from ..models.quant import twin_classes_for

            if self.rgb:
                raise ValueError("int8 supports the grayscale FCN families only")
            self._int8_twin = twin_classes_for(self.module)
        return self._int8_twin[1]

    def _calibrate(self, images: torch.Tensor) -> None:
        """One float32 forward of the calibrate twin over ``images`` / 255
        records the int8 twin's ranges."""
        from ..models.quant import calibrate

        self._twin()
        self.amax = calibrate(self._int8_twin[0], [images.to(torch.float32)[..., None] / 255.0])

    # ----------------------------------------------------------- params I/O
    def init_params(self, seed: int = 0) -> None:
        self.variables = init_variables(self.module, seed)

    def _rebuild(self, architecture: Architecture) -> None:
        self.architecture = architecture
        module = architecture.model(self.n_classes, dtype=self.compute_dtype, s2d_stem=self.s2d_stem)
        self.module = module.to(self.device).eval()
        self.preprocess, self.rgb = architecture.preprocess()
        if self._variables is not None:
            self.variables = self._variables

    def load(self, path: str) -> None:
        """A checkpoint directory (``params.msgpack`` + ``meta.json``;
        ``meta["architecture"]`` rebuilds the module) or a Keras ``.h5``
        (its ``model_config`` names the architecture when it can), or the
        path of a missing ``.h5`` beside which a TF1 ``.meta`` checkpoint
        lies (read by ``models/tf1_import.py``, which needs tensorflow)."""
        path = str(path)
        if path.endswith(".h5"):
            if not os.path.exists(path):
                if os.path.exists(path[:-3] + ".meta"):
                    from ..models.tf1_import import load_tf1_checkpoint

                    self.variables = {"params": load_tf1_checkpoint(
                        path[:-3] + ".meta", self.architecture, self.n_classes)}
                    return
                raise FileNotFoundError(f"No checkpoint at {path}")
            from ..models.h5_import import load_keras_variables

            variables, detected = load_keras_variables(path, self.architecture, self.n_classes)
            if detected is not None:
                self._variables = None
                self._rebuild(detected)
            self.variables = variables
            return
        from ..train.checkpoint import load_checkpoint

        variables, meta = load_checkpoint(path)
        arch = meta.get("architecture")
        if arch:
            self._variables = None
            self._rebuild(Architecture(arch))
        self.variables = variables

    # -------------------------------------------------------------- forward
    def _prepare_input(self, image: np.ndarray) -> Tuple[np.ndarray, Tuple[int, int]]:
        """Preprocess + pad one image to its bucket: HWC float32 (a gray
        page repeated to 3 channels for the RGB families)."""
        if self.rgb:
            image = gray_to_rgb(image)
        arr = np.asarray(self.preprocess(np.asarray(image, dtype=np.float32)), dtype=np.float32)
        if arr.ndim == 2:
            arr = arr[..., None]
        orig_hw = arr.shape[:2]
        target = bucket_shape(orig_hw, self.architecture.stride_factor, self.bucket_granularity)
        return pad_to(arr, target), orig_hw

    def predict_single_data(self, data: SingleData):
        """(logit, prob, pred) numpy arrays for one page."""
        from scipy.special import softmax

        arr, orig_hw = self._prepare_input(data.image)
        with torch.inference_mode():
            logits = self.module(torch.from_numpy(arr[None]).to(self.device))
        logit = crop_to(logits[0].cpu().numpy(), orig_hw)
        return logit, softmax(logit, -1), np.argmax(logit, -1)

    def masks_device(self, images: torch.Tensor, ink: Optional[torch.Tensor], pack: bool):
        """The batched dispatch on the device: (N, H, W) uint8 pages ->
        normalize, forward, argmax, then (``ink`` given: (N, H, W // 8)
        MSB-first bits, or (N, H, W) uint8) the cc-majority vote, and the
        class map as (N, H, W // 4) 2-bit codes (``pack``) or (N, H, W)
        uint8.  The RGB families normalize the padded page repeated to 3
        channels, as the JAX package does on the host, so the padding
        becomes the family's normalized 0, not 0.  With ``int8`` the int8
        twin runs, calibrated on the first batch."""
        from ..ops.cuda_cc import cc_vote_batch
        from .output import pack_classes_device, unpack_bits_device

        if self.int8 and self._amax is None:
            self._calibrate(images)
        module = self._twin() if self.int8 else self.module
        with torch.inference_mode():
            x = images.to(torch.float32)[..., None]
            if self.rgb:
                x = x.expand(-1, -1, -1, 3)
            x = self.architecture.device_preprocess()(x).permute(0, 3, 1, 2)
            pred = module.forward_nchw(x).argmax(dim=1).to(torch.uint8)
            if ink is not None:
                mask = unpack_bits_device(ink) if ink.shape[-1] * 8 == pred.shape[-1] else ink != 0
                pred = cc_vote_batch(pred, mask, n_classes=self.n_classes, device=pred.device)
            return pack_classes_device(pred) if pack else pred

    def predict_batch_masks(self, images: np.ndarray, binaries: np.ndarray,
                            palette: np.ndarray, device_vote: bool = False):
        """Batched forward + argmax of prepared pages of one bucket shape.

        images: (N, H, W) uint8; binaries: (N, H, W) uint8, 1 = ink.
        Returns host arrays (pred (N, H, W) uint8, masks (3, N, H, W, 3)
        uint8 = [color, overlay, inverted]).  The pages go up as uint8 and
        are normalized on the device; the class map comes back 2-bit packed
        when n_classes <= 4 and W % 4 == 0, and the trio is built on the
        host from the binary.  ``device_vote`` votes each ink component's
        majority class on the device before the download (the ink goes up
        1-bit packed when W % 8 == 0) with the CUDA labeler on the card."""
        from .output import finish_mask_trio, pack_bits_host, unpack_classes

        palette = np.ascontiguousarray(palette, np.uint8)
        pack = self.n_classes <= 4 and images.shape[2] % 4 == 0
        ink = (binaries != 0).astype(np.uint8)
        ink_dev = None
        if device_vote:
            ink_up = pack_bits_host(ink) if images.shape[2] % 8 == 0 else ink
            ink_dev = torch.from_numpy(ink_up).to(self.device)
        x = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(self.device)
        downloaded = self.masks_device(x, ink_dev, pack).cpu().numpy()
        pred = unpack_classes(downloaded) if pack else downloaded
        return pred, np.stack(finish_mask_trio(pred, ink, palette))



def network_for_model(model_path: str, n_classes: int, **kwargs) -> PixelClassifier:
    """The reference's ``Network("Predict", n_classes, model=path)``: a
    :class:`PixelClassifier` of the checkpoint at ``model_path``, on the
    card unless ``device=`` says otherwise."""
    return PixelClassifier(n_classes=n_classes, model_path=os.path.abspath(model_path), **kwargs)
