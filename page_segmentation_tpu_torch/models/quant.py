"""Post-training int8 quantization of the grayscale FCN families (torch).

Counterpart of ``page_segmentation_tpu/models/quant.py``.  The int8 twins
of FCNSkip and FCN run ``models/fcn.py``'s own graph with quantizing layers
(:class:`QConv`, :class:`QConvTranspose`) of the same parameter names and
shapes, so a float state dict loads into them unchanged:

    cal, q = twin_classes_for(float_module)   # weights copied, same device
    amax = calibrate(cal, [batch_nhwc])       # one float pass, any data
    amax_from_jax(q, amax)
    logits = q(images_nhwc)

Scheme, per conv (as the JAX package's):

* input: ``s_in = amax / 127`` (amax recorded over calibration batches);
  ``q_x = clip(round(x / s_in), -127, 127)`` as int8, rounding half to even;
* weights: per output channel, ``s_w = max |K| / 127`` over the other
  axes, quantized the same way;
* compute: int8 x int8 -> int32 accumulators, exact;
* output: ``acc * (s_in * s_w) + bias`` in float32, then the activation.

Symmetric scales keep zero at zero, so zero padding stays exact.

The integer convolution is an im2col patch matrix of the int8 input times
the int8 kernel matrix with ``torch._int_mm`` (int32 out): cuBLAS's integer
GEMM on the card, an exact integer product on the CPU.  cuDNN has no int8
convolution with an int32 result, and a float convolution over the integer
values is not exact (float32 holds integers to 2^24 only, where deconv3's
3000 taps reach 127² · 3000; Winograd and FFT algorithms round).  The card
needs M > 16 and K, N multiples of 8: the patch and kernel matrices are
zero-padded to those sizes, which adds nothing to the sums.  A 5x5 stride-1
transposed conv is the ordinary conv with the flipped, swapped kernel; a
2x2 stride-2 one has no overlap, so it is one GEMM per pixel (cin -> 4·cout)
and a depth-to-space.  The patch matrix is built in chunks of pages of
about 1 GiB.  Scales are device tensors: a division by a Python scalar
becomes a multiplication by its reciprocal on the card, which is not the
JAX package's rounding.

``mode="calibrate"`` runs float32 and records ``amax`` = max |input| per
layer; ``mode="float"`` runs float and equals ``models/fcn.py`` bit for
bit.  The ``amax`` buffers are not part of the state dict;
``models/bridge.py`` ``amax_to_jax`` / ``amax_from_jax`` carry them in the JAX package's
``amax`` collection layout (``{"conv1": {"in": ...}, ...}``).
"""
from __future__ import annotations

from typing import Iterable

import numpy as np
import torch
import torch.nn.functional as F

from .bridge import amax_from_jax, amax_to_jax
from .fcn import FCN, FCNSkip, _FCNBase
from .layers import TFConv, TFConvTranspose

MODES = ("int8", "calibrate", "float")
PATCH_BYTES = 1 << 30  # int8 patch matrix per GEMM chunk


def _quantize_symmetric(x, scale):
    """Round half to even, clip to [-127, 127], int8; ``scale`` is a tensor
    on ``x``'s device, 0-d or broadcastable per channel."""
    return torch.round(x / scale).clamp(-127, 127).to(torch.int8)


def _round8(x: int) -> int:
    return -(-x // 8) * 8


def _int_matmul(patches, weight_mat):
    """(M, K') int8 @ (K, N) int8 -> (M, N) int32, exact.  The card's
    integer GEMM wants M > 16 and K, N multiples of 8: the patches are
    zero-padded to that unless they come padded (K' >= K zero columns
    beyond K), the kernel matrix to the patches' K; the padding is cropped
    off the result."""
    m, k = patches.shape
    n = weight_mat.shape[1]
    kp, mp = _round8(k), max(m, 17)
    if (mp, kp) != (m, k):
        patches = F.pad(patches, (0, kp - k, 0, mp - m))
    # the kernel matrix column-major: (N, K) contiguous, transposed
    wt = F.pad(weight_mat.t(), (0, kp - weight_mat.shape[0], 0, _round8(n) - n)).contiguous()
    return torch._int_mm(patches, wt.t())[:m, :n]


def _widest(c: int) -> torch.dtype:
    """The widest integer type whose size divides ``c`` bytes: a run of c
    int8 channels moves as c / size elements of it."""
    for dtype in (torch.int64, torch.int32, torch.int16):
        if c % dtype.itemsize == 0:
            return dtype
    return torch.int8


class _Quantized:
    """The int8/calibrate/float behaviour shared by :class:`QConv` and
    :class:`QConvTranspose` (mixed in before the float layer)."""

    mode = "float"

    def _init_quant(self):
        self.register_buffer("amax", torch.zeros(()), persistent=False)

    def forward(self, x):
        if self.mode == "float":
            return super().forward(x)
        if self.mode == "calibrate":
            with torch.no_grad():
                self.amax.copy_(torch.maximum(self.amax, x.detach().abs().max().float()))
            return super().forward(x)
        if self.mode != "int8":
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        y = self.accumulate(x).float() * (self.input_scale() * self.weight_scale())[:, None, None]
        y = y + self.bias[:, None, None]
        return F.relu(y) if self.relu else y

    def input_scale(self):
        return self.amax.clamp_min(1e-12) / self.amax.new_tensor(127.0)

    def weight_scale(self):
        """Per output channel (F,)."""
        w = self.weight.detach()
        dims = (0, 2, 3) if isinstance(self, TFConvTranspose) else (1, 2, 3)
        return w.abs().amax(dim=dims).clamp_min(1e-12) / w.new_tensor(127.0)

    def quantized_weight(self):
        w = self.weight.detach()
        s_w = self.weight_scale()
        shape = (1, -1, 1, 1) if isinstance(self, TFConvTranspose) else (-1, 1, 1, 1)
        return _quantize_symmetric(w, s_w.reshape(shape))

    def accumulate(self, x):
        """The int32 accumulators (N, F, H', W') of the quantized input with
        the quantized kernel."""
        q = _quantize_symmetric(x.detach().float(), self.input_scale())
        return self._int_conv(q.permute(0, 2, 3, 1), self._conv_weight())


class QConv(_Quantized, TFConv):
    """``TFConv`` (stride 1, SAME) with the int8, calibrate and float modes."""

    def __init__(self, *args, mode: str = "float", **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant()
        self.mode = mode

    def _conv_weight(self):
        return self.quantized_weight()  # (F, C, kh, kw)

    def _int_conv(self, q_nhwc, w):
        if self.strides != (1, 1) or self.groups != 1 or self.padding != "SAME":
            raise NotImplementedError("int8 QConv runs stride-1 SAME convs only")
        return _conv_same_int(q_nhwc, w)


class QConvTranspose(_Quantized, TFConvTranspose):
    """``TFConvTranspose`` (Keras SAME) with the int8, calibrate and float
    modes: the JAX package's ``QConv(transpose=True)``."""

    def __init__(self, *args, mode: str = "float", **kwargs):
        super().__init__(*args, **kwargs)
        self._init_quant()
        self.mode = mode

    def _conv_weight(self):
        return self.quantized_weight()  # (C, F, kh, kw)

    def _int_conv(self, q_nhwc, w):
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        if (sh, sw) == (1, 1) and kh % 2 and kw % 2:
            # full transposed conv cropped by (k - 1) / 2 = the SAME conv with
            # the kernel flipped and in/out swapped
            return _conv_same_int(q_nhwc, w.transpose(0, 1).flip(2, 3))
        if (kh, kw) == (sh, sw):
            return _deconv_no_overlap_int(q_nhwc, w)
        raise NotImplementedError(
            "int8 QConvTranspose runs odd kernels at stride 1 and kernel == stride only")


def _chunks(n: int, bytes_per_page: int):
    step = max(1, PATCH_BYTES // max(bytes_per_page, 1))
    return range(0, n, step), step


def _conv_same_int(q_nhwc, w):
    """Stride-1 SAME conv of int8 NHWC ``q_nhwc`` with int8 (F, C, kh, kw)
    ``w`` -> int32 (N, F, H, W) (an NCHW view of NHWC memory), by im2col
    chunks of pages."""
    n, h, wd, c = q_nhwc.shape
    f, _, kh, kw = w.shape
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    padded = F.pad(q_nhwc, (0, 0, pw, kw - 1 - pw, ph, kh - 1 - ph)).contiguous()
    # K ordered (kh, kw, C): each tap's C channels are one contiguous run of
    # the NHWC input; the copy moves them as wider integers
    k = kh * kw * c
    weight_mat = w.permute(0, 2, 3, 1).reshape(f, k).t()
    wide = _widest(c)
    cw = c // wide.itemsize
    source = padded.view(wide)
    out = torch.empty((n, h, wd, f), dtype=torch.int32, device=q_nhwc.device)
    starts, step = _chunks(n, h * wd * _round8(k))
    for start in starts:
        part = source[start : start + step]
        m = part.shape[0] * h * wd
        # the (M, K) patch matrix in a buffer already padded to the GEMM's
        # shape rules: K to a multiple of 8 (so a multiple of every width),
        # M to 17 rows
        patches = torch.empty((max(m, 17), _round8(k)), dtype=torch.int8, device=q_nhwc.device)
        patches[:, k:].zero_()
        patches[m:].zero_()
        windows = part.unfold(1, kh, 1).unfold(2, kw, 1).permute(0, 1, 2, 4, 5, 3)
        patches.view(wide)[:m, : k // wide.itemsize].view(-1, h, wd, kh, kw, cw).copy_(windows)
        out[start : start + step].view(m, f).copy_(_int_matmul(patches, weight_mat)[:m])
    return out.permute(0, 3, 1, 2)


def _deconv_no_overlap_int(q_nhwc, w):
    """Transposed conv with kernel == stride of int8 NHWC ``q_nhwc`` with
    int8 (C, F, kh, kw) ``w`` -> int32 (N, F, H*kh, W*kw) (an NCHW view of
    NHWC memory): each input pixel writes its own kh x kw block."""
    n, h, wd, c = q_nhwc.shape
    _, f, kh, kw = w.shape
    acc = _int_matmul(q_nhwc.reshape(n * h * wd, c), w.reshape(c, f * kh * kw))
    acc = acc.reshape(n, h, wd, f, kh, kw).permute(0, 1, 4, 2, 5, 3)
    return acc.reshape(n, h * kh, wd * kw, f).permute(0, 3, 1, 2)


class _QuantFCNBase(_FCNBase):
    """The FCN graph of ``models/fcn.py`` with quantizing layers, computing
    float32 in its float and calibrate modes."""

    conv_layer = QConv
    deconv_layer = QConvTranspose

    def __init__(self, n_classes: int, mode: str = "int8", in_channels: int = 1):
        super().__init__(n_classes, dtype=torch.float32, in_channels=in_channels)
        self.set_mode(mode)

    def set_mode(self, mode: str) -> None:
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode = mode
        for layer in self.quant_layers():
            layer.mode = mode

    def quant_layers(self):
        return [m for m in self.modules() if isinstance(m, _Quantized)]

    @classmethod
    def pair(cls, n_classes: int):
        """(calibrate twin, int8 twin), fresh weights."""
        return cls(n_classes, mode="calibrate"), cls(n_classes, mode="int8")


class QuantFCNSkip(_QuantFCNBase):
    """The int8 twin of ``FCNSkip``."""

    skips = True


class QuantFCN(_QuantFCNBase):
    """The int8 twin of ``FCN``."""

    skips = False


_QUANT_TWINS = {"fcn_skip": QuantFCNSkip, "fcn": QuantFCN}


def calibrate(calibrate_module, batches: Iterable) -> dict:
    """One forward per batch in calibrate mode, from zero ranges; returns the
    running max of |input| per layer as an ``amax`` collection.  ``batches``:
    (N, H, W, C) float arrays or tensors normalized as the inference inputs
    will be (inverted, /255, bucket-padded)."""
    device = next(calibrate_module.parameters()).device
    calibrate_module.set_mode("calibrate")
    for layer in calibrate_module.quant_layers():
        layer.amax.zero_()
    seen = False
    with torch.no_grad():
        for batch in batches:
            calibrate_module(torch.as_tensor(batch, dtype=torch.float32).to(device))
            seen = True
    if not seen:
        raise ValueError("calibrate() needs at least one batch")
    return amax_to_jax(calibrate_module)


def twin_classes_for(module):
    """(calibrate twin, int8 twin) of a float FCNSkip/FCN: the module's
    weights copied into both, on its device.  (The JAX package returns
    unbound twins; a torch module carries its weights.)"""
    if isinstance(module, FCNSkip):
        cls = QuantFCNSkip
    elif isinstance(module, FCN):
        cls = QuantFCN
    else:
        raise ValueError(
            f"int8 quantization supports the grayscale FCN families "
            f"(fcn/fcn_skip); got {type(module).__name__}")
    device = next(module.parameters()).device
    in_channels = module.conv1.weight.shape[1]
    state = module.state_dict()
    twins = []
    for mode in ("calibrate", "int8"):
        twin = cls(module.n_classes, mode=mode, in_channels=in_channels).to(device).eval()
        twin.load_state_dict(state)
        twins.append(twin)
    return tuple(twins)


def quantize_for_inference(architecture: str, n_classes: int, params, calib_batches,
                           device="cuda"):
    """The calibrated int8 twin of ``architecture`` ('fcn_skip' or 'fcn') with
    the JAX-layout ``params`` on ``device``, and its ``amax`` collection."""
    from ..device import resolve_device
    from .bridge import params_from_jax

    if architecture not in _QUANT_TWINS:
        raise ValueError(f"int8 quantization supports {sorted(_QUANT_TWINS)}; got {architecture!r}")
    dev = resolve_device(device)
    cal, q = (m.to(dev).eval() for m in _QUANT_TWINS[architecture].pair(n_classes))
    state = params_from_jax(params)
    cal.load_state_dict(state)
    q.load_state_dict(state)
    amax = calibrate(cal, calib_batches)
    amax_from_jax(q, amax)
    return q, amax
