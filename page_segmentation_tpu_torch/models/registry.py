"""The architecture registry.

Counterpart of ``Architecture`` in ``page_segmentation_tpu/models/registry.py``:
the 14 names, their preprocess modes (Keras ``preprocess_input``
conventions: 'gray' /255, 'caffe' BGR minus the ImageNet means, 'tf' to
[-1, 1], 'torch' [0, 1] then ImageNet mean/std), the host and device (torch)
normalization functions and the stride factors.  ``model()`` builds each
of the 14 in eval mode (the JAX modules' default ``train=False``).
``Optimizers`` names the seven optimizers; ``make`` builds one as
``train/optim.py`` writes it, with Keras' per-tensor ``clipnorm`` on by
default.
"""
from __future__ import annotations

import enum
from typing import Callable, Tuple

import numpy as np
import torch

_CAFFE_MEAN = (103.939, 116.779, 123.68)  # BGR order after the flip
_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


def _make_preprocess(mode: str, device: bool):
    """The normalization of ``mode``: for numpy arrays on the host, or for
    torch tensors (any device) with ``device``."""
    if mode == "gray":
        return lambda x: x / 255.0
    if mode == "tf":
        return lambda x: x / 127.5 - 1.0
    if device:
        if mode == "caffe":
            return lambda x: x.flip(-1) - x.new_tensor(_CAFFE_MEAN)
        return lambda x: (x / 255.0 - x.new_tensor(_TORCH_MEAN)) / x.new_tensor(_TORCH_STD)
    if mode == "caffe":
        mean = np.asarray(_CAFFE_MEAN, np.float32)
        return lambda x: x[..., ::-1] - mean
    mean, std = np.asarray(_TORCH_MEAN, np.float32), np.asarray(_TORCH_STD, np.float32)
    return lambda x: (x / 255.0 - mean) / std


def default_preprocess(x):
    """Grayscale normalization, x / 255."""
    return x / 255.0


class Architecture(enum.Enum):
    FCN_SKIP = "fcn_skip"
    FCN = "fcn"
    RES_NET = "image_res_net"
    RES_UNET = "res_unet"
    MOBILE_NET = "mobile_net"
    UNET = "unet"
    EFFNETB0 = "effb0"
    EFFNETB1 = "effb1"
    EFFNETB2 = "effb2"
    EFFNETB3 = "effb3"
    EFFNETB4 = "effb4"
    EFFNETB5 = "effb5"
    EFFNETB6 = "effb6"
    EFFNETB7 = "effb7"

    def model(self, n_classes: int, dtype=None, s2d_stem: bool = False):
        """The torch module of this architecture, computing in ``dtype``
        (float32 by default), in eval mode.  ``s2d_stem`` (fcn/fcn_skip)
        runs the stem convs in the space-to-depth layout
        (``models/s2d.py``); the other families ignore it, as in the JAX
        package."""
        dtype = dtype or torch.float32
        if self.value.startswith("effb"):
            from .efficientnet import EffNetSeg

            return EffNetSeg(n_classes, variant=self.value, dtype=dtype).eval()
        from .fcn import FCN, FCNSkip
        from .mobilenet import MobileNetSeg
        from .res_unet import ResUNet
        from .resnet import ResNet50Seg
        from .unet import UNet

        cls = {
            Architecture.FCN_SKIP: FCNSkip,
            Architecture.FCN: FCN,
            Architecture.UNET: UNet,
            Architecture.RES_UNET: ResUNet,
            Architecture.RES_NET: ResNet50Seg,
            Architecture.MOBILE_NET: MobileNetSeg,
        }[self]
        if cls in (FCNSkip, FCN):
            return cls(n_classes, dtype=dtype, s2d_stem=s2d_stem).eval()
        return cls(n_classes, dtype=dtype).eval()

    @property
    def preprocess_mode(self) -> str:
        return {
            Architecture.FCN_SKIP: "gray",
            Architecture.FCN: "gray",
            Architecture.UNET: "gray",
            Architecture.RES_UNET: "gray",
            Architecture.RES_NET: "caffe",
            Architecture.MOBILE_NET: "tf",
        }.get(self, "torch")  # EfficientNet family

    def preprocess(self) -> Tuple[Callable, bool]:
        """(host preprocess fn on numpy arrays, needs-RGB)."""
        mode = self.preprocess_mode
        host = _make_preprocess(mode, device=False)
        if mode == "gray":
            return host, False

        def as_float(x, _host=host):
            return _host(np.asarray(x, dtype=np.float32))

        return as_float, True

    def device_preprocess(self) -> Callable:
        """The torch twin of :meth:`preprocess`'s function, for normalizing
        uploaded uint8 pixels on the device."""
        return _make_preprocess(self.preprocess_mode, device=True)

    @property
    def stride_factor(self) -> int:
        """Total downsampling factor: input H/W must be a multiple of this."""
        return {
            Architecture.FCN_SKIP: 8,
            Architecture.FCN: 8,
            Architecture.UNET: 16,
            Architecture.RES_UNET: 16,
            Architecture.RES_NET: 32,
            Architecture.MOBILE_NET: 32,
        }.get(self, 32)


class Optimizers(enum.Enum):
    ADAM = "adam"
    ADAMAX = "adamax"
    ADADELTA = "adadelta"
    ADAGRAD = "adagrad"
    RMSPROP = "rmsprop"
    SGD = "sgd"
    NADAM = "nadam"

    def make(
        self,
        l_rate,
        norm_clipping: bool = True,
        norm_clip_value: float = 1.0,
        value_clipping: bool = False,
        clip_value: float = 1.0,
        grad_accum: int = 1,
    ):
        """The optimizer (``train/optim.py`` ``Optimizer``): ``l_rate`` is a
        float or a schedule (update count -> float32 tensor); ``grad_accum``
        > 1 applies the mean of that many micro-gradients at once."""
        from ..train.optim import Optimizer

        return Optimizer(self.value, l_rate, norm_clipping=norm_clipping,
                         norm_clip_value=norm_clip_value, value_clipping=value_clipping,
                         clip_value=clip_value, grad_accum=grad_accum)
