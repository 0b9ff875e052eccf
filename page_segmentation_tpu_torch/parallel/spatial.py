"""Row bands of one tall page: the receptive-field halo scheme.

Counterpart of ``page_segmentation_tpu/parallel/spatial.py``.  Every
architecture but EfficientNet is a finite-receptive-field conv net with zero
SAME padding, so the logits of a row band, computed on a window that
extends it by ``margin >= receptive_field / 2`` real page rows, equal the
unsplit forward's.  :func:`banded_forward` runs the bands one after another
on one device: the peak device memory is one window's activations instead of
the whole page's.

A zero halo is not the same as SAME padding (zeros through a biased conv
stop being zero after one layer), so no window holds a synthetic margin:
every window has the same ``band_rows + 2 * margin`` rows and is shifted at
the page edges, the first starting at the page's top row and the last ending
at its bottom row.  Margins and bands are multiples of the stride factor, so
the pooling grids align across the split.

The multi-device forms (``spatial_forward``, ``spatial_forward_batch``,
``spatial_predict``: bands across a device mesh with halo exchange) are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.pad import round_up

# half receptive fields in rows, measured by single-row perturbation
# (measure_half_rf: fcn_skip/fcn 72, unet 85, res_unet 109, mobile_net 44,
# image_res_net 153) and rounded up to the stride factor.  EfficientNet is
# absent on purpose: its squeeze-excite blocks pool over the whole page, so
# a band's logits depend on every row and banding is not exact there.
DEFAULT_MARGINS = {
    "fcn_skip": 80,
    "fcn": 80,
    "unet": 96,
    "res_unet": 112,
    "mobile_net": 64,
    "image_res_net": 192,
}

_NOT_PORTED = ("spatial partitioning over several devices is not ported yet: "
               "ROADMAP queue 1 item 12b")


def _forward(module, window: np.ndarray) -> np.ndarray:
    """One (H, W, C) float32 window through ``module`` on its own device:
    (H, W, n_classes) float32 logits on the host."""
    device = next(module.parameters()).device
    with torch.inference_mode():
        logits = module(torch.from_numpy(np.ascontiguousarray(window[None])).to(device))
    return logits[0].float().cpu().numpy()


def measure_half_rf(module, height: int = 1024, width: int = 32, channels: int = 1) -> int:
    """Empirical half receptive field of ``module`` (with its weights), in
    rows: poke one input row and find the farthest output row whose logits
    move by more than 1e-6."""
    probe = height // 2
    base = np.zeros((height, width, channels), np.float32)
    poked = base.copy()
    poked[probe] = 1.0
    moved = np.abs(_forward(module, poked) - _forward(module, base)).max(axis=(1, 2))
    support = np.flatnonzero(moved > 1e-6)
    if len(support) == 0:
        raise ValueError("perturbation produced no logit change; RF unmeasurable")
    return int(max(probe - support.min(), support.max() - probe))


def derived_margin(architecture, module=None) -> int:
    """The architecture's halo margin: its measured half receptive field
    (``module``'s weights, or seeded random ones) rounded up to the stride
    factor."""
    if module is None:
        from ..models.bridge import init_variables_numpy, params_from_jax

        module = architecture.model(3)
        module.load_state_dict(params_from_jax(init_variables_numpy(module, 0)))
    channels = 3 if architecture.preprocess()[1] else 1
    half = measure_half_rf(module, channels=channels)
    return round_up(half, architecture.stride_factor)


def banded_forward(module, image: np.ndarray, band_rows: int = 1024, margin: int = 96,
                   stride_factor: int = 8) -> np.ndarray:
    """Logits (H, W, n_classes) of one (H, W[, C]) page, forwarded in
    sequential row bands of ``band_rows`` on ``module``'s device.

    The page is zero-padded bottom/right to the stride factor (as the
    classifier pads it) and every window is ``band_rows + 2 * margin`` rows
    of it; a page that fits one window runs whole."""
    margin = round_up(margin, stride_factor)
    band_rows = round_up(max(band_rows, stride_factor), stride_factor)
    h, w = image.shape[:2]
    c = image.shape[2] if image.ndim == 3 else 1
    padded_h, padded_w = round_up(h, stride_factor), round_up(w, stride_factor)
    full = np.zeros((padded_h, padded_w, c), np.float32)
    full[:h, :w] = np.asarray(image, np.float32).reshape(h, w, c)
    win_h = band_rows + 2 * margin
    if win_h >= padded_h:
        return _forward(module, full)[:h, :w]

    out = None
    for start in range(0, padded_h, band_rows):
        rows = min(band_rows, padded_h - start)
        lo = min(max(0, start - margin), padded_h - win_h)
        logits = _forward(module, full[lo : lo + win_h])
        if out is None:
            out = np.empty((padded_h, padded_w, logits.shape[-1]), logits.dtype)
        offset = start - lo
        out[start : start + rows] = logits[offset : offset + rows]
    return out[:h, :w]


def spatial_forward(module, image, mesh=None, margin: int = 96, axis: str = "data",
                    stride_factor: int = 8):
    """One page split row-wise across a device mesh: not ported yet."""
    raise NotImplementedError(_NOT_PORTED)


def spatial_forward_batch(module, pages, mesh=None, margin: int = 96, data_axis: str = "data",
                          space_axis: str = "space", stride_factor: int = 8):
    """Pages x bands over a 2-D device mesh: not ported yet."""
    raise NotImplementedError(_NOT_PORTED)


def spatial_predict(classifier, image, mesh=None, margin: Optional[int] = None):
    """argmax of one oversized page across a device mesh: not ported yet."""
    raise NotImplementedError(_NOT_PORTED)
