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

Across a device mesh (``spatial_forward``, ``spatial_forward_batch``,
``spatial_predict``) each device holds one band of ``band_h`` rows and
evaluates a ``band_h + 2 * margin`` window of real rows: its own band plus
halos, the neighbours' ``2 * margin`` edge rows, copied device to device
(``tensor.to(neighbour, non_blocking=True)``, a peer copy between cards).
The window starts at offset 0 at the top, ``2 * margin`` at the bottom and
``margin`` in between, as the JAX package's ``shard_map`` program does.
Each device runs the module's copy on that device
(``parallel/mesh.py`` ``replicas_of``).
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


def _spatial_run(module, bands, margin: int):
    """The band program over one row of devices: ``bands`` are (N, band_h,
    W, C) float32 tensors, one per device, top to bottom.  Returns each
    band's logits (N, band_h, W, n_classes), on its device."""
    from .mesh import replicas_of

    n_dev = len(bands)
    if n_dev == 1:
        # no split: a halo ring would wrap the band onto itself
        with torch.inference_mode():
            return [replicas_of(module).on(bands[0].device)(bands[0])]
    devices = [band.device for band in bands]
    # halos: the band above's bottom 2*margin rows, the band below's top
    # 2*margin rows, copied to this band's device
    above2 = [bands[i - 1][:, -2 * margin :].to(devices[i], non_blocking=True) if i > 0 else None
              for i in range(n_dev)]
    below2 = [bands[i + 1][:, : 2 * margin].to(devices[i], non_blocking=True)
              if i < n_dev - 1 else None for i in range(n_dev)]
    out = []
    with torch.inference_mode():
        for i, band in enumerate(bands):
            if i == 0:
                window, offset = torch.cat([band, below2[i]], dim=1), 0
            elif i == n_dev - 1:
                window, offset = torch.cat([above2[i], band], dim=1), 2 * margin
            else:
                window = torch.cat([above2[i][:, margin:], band, below2[i][:, :margin]], dim=1)
                offset = margin
            logits = replicas_of(module).on(devices[i])(window)
            out.append(logits[:, offset : offset + band.shape[1]])
    return out


def _band_height(padded_h: int, n_space: int, margin: int, advice: str) -> int:
    band_h = padded_h // n_space
    if n_space != 1 and band_h < 2 * margin:
        raise ValueError(f"band height {band_h} smaller than 2x halo margin {margin}; {advice}")
    return band_h


def spatial_forward(module, image: np.ndarray, mesh, margin: int = 96, axis: str = "data",
                    stride_factor: int = 8) -> np.ndarray:
    """Logits (H, W, n_classes) of one (H, W[, C]) page split row-wise
    across every device of ``mesh``.  H is padded to ``n_devices *
    stride_factor`` (W to the stride factor) and cropped back."""
    devices = list(mesh.devices.flat)
    n_dev = len(devices)
    margin = round_up(margin, stride_factor)
    h, w = image.shape[:2]
    c = image.shape[2] if image.ndim == 3 else 1
    padded_h = round_up(h, n_dev * stride_factor)
    padded_w = round_up(w, stride_factor)
    full = np.zeros((padded_h, padded_w, c), np.float32)
    full[:h, :w] = np.asarray(image, np.float32).reshape(h, w, c)
    band_h = _band_height(padded_h, n_dev, margin, "use fewer devices or a taller page")
    bands = [torch.from_numpy(full[None, i * band_h : (i + 1) * band_h]).to(d, non_blocking=True)
             for i, d in enumerate(devices)]
    logits = _spatial_run(module, bands, margin)
    return np.concatenate([out[0].float().cpu().numpy() for out in logits])[:h, :w]


def spatial_forward_batch(module, pages: np.ndarray, mesh, margin: int = 96,
                          data_axis: str = "data", space_axis: str = "space",
                          stride_factor: int = 8) -> np.ndarray:
    """Logits (N, H, W, n_classes) of a batch of same-sized pages over a 2-D
    (pages x bands) mesh: the batch splits across ``data_axis`` and every
    page's rows across ``space_axis``, with the halo scheme of
    :func:`spatial_forward`.  A ragged batch pads with zero pages."""
    grid = np.moveaxis(mesh.devices, [mesh.axis_names.index(data_axis),
                                      mesh.axis_names.index(space_axis)], [0, 1])
    grid = grid.reshape(grid.shape[0], grid.shape[1], -1)[..., 0]
    n_data, n_space = grid.shape
    margin = round_up(margin, stride_factor)
    n, h, w = pages.shape[:3]
    c = pages.shape[3] if pages.ndim == 4 else 1
    padded_n = round_up(n, n_data)
    padded_h = round_up(h, n_space * stride_factor)
    padded_w = round_up(w, stride_factor)
    full = np.zeros((padded_n, padded_h, padded_w, c), np.float32)
    full[:n, :h, :w] = np.asarray(pages, np.float32).reshape(n, h, w, c)
    band_h = _band_height(padded_h, n_space, margin,
                          "use fewer space-axis devices or taller pages")
    per = padded_n // n_data
    rows = []
    for i in range(n_data):
        chunk = full[i * per : (i + 1) * per]
        bands = [torch.from_numpy(chunk[:, j * band_h : (j + 1) * band_h]).to(grid[i, j],
                                                                              non_blocking=True)
                 for j in range(n_space)]
        rows.append(_spatial_run(module, bands, margin))
    logits = np.concatenate([np.concatenate([b.float().cpu().numpy() for b in row], axis=1)
                             for row in rows])
    return logits[:n, :h, :w]


def spatial_predict(classifier, image: np.ndarray, mesh, margin: Optional[int] = None):
    """argmax labels (H, W) of one oversized page, forwarded across ``mesh``
    (a gray page repeated to 3 channels for the RGB families)."""
    from ..utils import gray_to_rgb

    margin = margin or DEFAULT_MARGINS.get(classifier.architecture.value, 192)
    image = gray_to_rgb(image) if classifier.rgb else image
    arr = np.asarray(classifier.preprocess(np.asarray(image, np.float32)), np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    logits = spatial_forward(classifier.module, arr, mesh, margin=margin,
                             stride_factor=classifier.architecture.stride_factor)
    return logits.argmax(-1)
