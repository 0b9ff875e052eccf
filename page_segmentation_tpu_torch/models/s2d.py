"""Space-to-depth rewrite of the full-resolution stem convs (torch).

Counterpart of ``page_segmentation_tpu/models/s2d.py``.  The first two
convs of fcn/fcn_skip (5x5, 1 -> 20 and 20 -> 30 channels, stride 1) run at
the page's full resolution with a contraction of only 25 (conv1) taps.  On
a space-to-depth(4) layout, ``x_s2d[n, (di*4 + dj)*C + c, i, j] =
x[n, c, 4i + di, 4j + dj]``, the same stride-1 SAME conv is a (3, 3) conv
from 16C to 16F channels on a 4x smaller grid, whose kernel is a gather of
the (5, 5) one with structural zeros (25 of the 9*16*16 tap/phase
combinations are nonzero).  Each output value sums the same 25 products, so
the result equals the dense stem's up to summation order.

The layouts are the port's: NCHW activations and (out, in, kh, kw)
kernels; channel orders are the JAX package's.  Torch ops only, and
differentiable: gradients reach the (5, 5) parameters through the gather,
so checkpoints are the same with the stem on or off.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def space_to_depth(x, block: int):
    """(N, C, H, W) -> (N, b*b*C, H/b, W/b); channel = (di*b + dj)*C + c."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // block, block, w // block, block)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, block * block * c, h // block, w // block)


def depth_to_space(x, block: int):
    """Inverse of :func:`space_to_depth`."""
    n, cc, hb, wb = x.shape
    c = cc // (block * block)
    x = x.reshape(n, block, block, c, hb, wb)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, hb * block, wb * block)


def _phase_maps(k: int, block: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Index and mask arrays of one spatial axis of the kernel rewrite.

    Rewritten tap ``a`` (of A, shifted to start at 0), input phase ``pi``
    and output phase ``po`` read the original tap ``kh = block*a' + pi -
    po + pad`` (``a'`` the unshifted cell offset, pad = (k - 1) // 2) when
    it lies in [0, k).  Returns (kh_idx, valid), each (A, block, block)
    indexed [a, pi, po], and A."""
    pad = (k - 1) // 2
    amin = (0 - pad) // block
    amax = (block - 1 + k - 1 - pad) // block
    extent = amax - amin + 1
    kh_idx = np.zeros((extent, block, block), np.int64)
    valid = np.zeros((extent, block, block), bool)
    for ai, a in enumerate(range(amin, amax + 1)):
        for pi in range(block):
            for po in range(block):
                kh = block * a + pi - po + pad
                if 0 <= kh < k:
                    kh_idx[ai, pi, po] = kh
                    valid[ai, pi, po] = True
    return kh_idx, valid, extent


def s2d_conv_kernel(weight, block: int = 4):
    """A (cout, cin, k, k) stride-1 SAME conv kernel -> the equivalent
    (b²·cout, b²·cin, A, A) kernel on the space-to-depth(b) layout (A = 3 for
    5x5 at b = 4): input channel ``(pi_h*b + pi_w)*cin + ci``, output
    ``(po_h*b + po_w)*cout + co``.  The rewritten conv's zero padding reads
    the zeros the dense conv's padding reads."""
    cout, cin, k, kw_ = weight.shape
    if k != kw_:
        raise ValueError(f"square kernels only, got {k}x{kw_}")
    kh_idx, valid, extent = _phase_maps(k, block)
    idx = torch.from_numpy(kh_idx).to(weight.device)
    mask = torch.from_numpy(valid[:, :, :, None, None, None] & valid[None, None, None]).to(weight.device)
    # (cout, cin, a, pi_h, po_h, b, pi_w, po_w)
    gathered = weight[:, :, idx][..., idx]
    gathered = torch.where(mask, gathered, torch.zeros((), dtype=weight.dtype, device=weight.device))
    # -> (po_h, po_w, cout, pi_h, pi_w, cin, a, b)
    gathered = gathered.permute(4, 7, 0, 3, 6, 1, 2, 5)
    bb = block * block
    return gathered.reshape(bb * cout, bb * cin, extent, extent)


def s2d_bias(bias, block: int = 4):
    """A (cout,) bias tiled to the s2d channel order (po*cout + co)."""
    return bias.repeat(block * block)


def stem_applicable(shape, block: int = 4) -> bool:
    """The rewrite needs H and W of an NCHW ``shape`` divisible by
    ``block``; bucketed shapes are multiples of 8, so it holds on the
    predict paths."""
    return shape[-2] % block == 0 and shape[-1] % block == 0


def s2d_stem(x, layers: Sequence, block: int = 4, dtype: Optional[torch.dtype] = None):
    """A chain of stride-1 SAME convs run in the s2d layout: ``layers`` is a
    sequence of (weight (cout, cin, k, k), bias or None, relu); one
    space-to-depth at entry and one depth-to-space at exit.  Each conv runs
    in ``dtype`` (the input's by default) with its bias added after it."""
    y = space_to_depth(x, block)
    for weight, bias, relu in layers:
        dt = dtype or y.dtype
        kernel = s2d_conv_kernel(weight, block).to(dt)
        y = F.conv2d(y.to(dt), kernel, padding=(kernel.shape[-2] - 1) // 2)
        if bias is not None:
            y = y + s2d_bias(bias, block).to(dt)[:, None, None]
        if relu:
            y = F.relu(y)
    return depth_to_space(y, block)
