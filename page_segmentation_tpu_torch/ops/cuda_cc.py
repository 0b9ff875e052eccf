"""Connected-component min-labels and the cc-majority vote (torch + CUDA).

Counterpart of ``page_segmentation_tpu/ops/pallas_cc.py``, with the same
public names and the same label contract: for each page, ink pixel p gets
1 + the smallest row-major flat index, within its own page, over its
4-connected component; background gets 0; int32.  The second value each
labeler returns (sweeps / passes) is specific to the algorithm.

Two implementations of that contract:

* the hand-written CUDA block-based union-find labeler ``csrc/cc_label.cu``,
  launched for tensors on the card: :data:`LAUNCHES_PER_CALL` kernels per
  call, one C call from :func:`_label_cuda`.  A tile pass labels each 32×32
  tile in shared memory and writes every pixel's tile root; a border pass
  unites the components across tile edges in the output array itself; a
  flatten pass points every pixel at its final root.  A bool or uint8 tensor
  goes to the kernel as it is (nonzero is ink), into one int32 output;
* :func:`cc_min_label_reference`, the plain PyTorch version: segmented
  Hillis-Steele min-scans to a fixed point, the algorithm of
  ``cc_min_label_xla_batch``.  Tensors on the CPU take it.

A CUDA tensor launches the kernel or raises; nothing falls back.  On the
TPU the whole-page kernel (``cc_min_label_pallas``) and the banded one
(``cc_min_label_tiled``) exist because the label map must fit in VMEM; on
the card both entry points launch the same kernel.

The vote is torch ops on either device (the JAX package computes it in XLA
outside Pallas): one scatter-add histogram over (page, component, class),
an argmax with ties to the lowest class, and a gather back onto ink.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .._kernels import Entry, launch
from ..device import on_card, resolve_device
from ..train.profiling import span

# kernel launches of csrc/cc_label.cu made by this process
launches = 0
_launch_lock = threading.Lock()
# kernels one labeler call launches: tile, border, flatten
LAUNCHES_PER_CALL = 3

# the TPU's single-block size limit, kept so cc_min_label dispatches
# between the two entry points as the JAX package does
_VMEM_BUDGET_PIXELS = 240_000
_MAX_GRID_Z = 65_535
# the JAX labelers' sweep cap, applied to the plain version's cycles
_MAX_CYCLES = 4096

_CC_LABEL = Entry("cc_label", "ps_cc_label",
                  (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int))


# ----------------------------------------------------------------- the kernel
def _label_cuda(ink: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool/uint8 ink on the card (nonzero = ink) -> int32
    labels, by the union-find kernels on the current stream."""
    global launches
    if ink.device.type != "cuda":
        raise ValueError(f"_label_cuda needs a CUDA tensor, got {ink.device}")
    if ink.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"ink must be bool or uint8, got {ink.dtype}")
    if ink.dim() != 3 or not ink.is_contiguous():
        raise ValueError(f"ink must be a contiguous (N, H, W) tensor, got {tuple(ink.shape)}")
    n, h, w = ink.shape
    if n > _MAX_GRID_Z or h * w >= 2**31:
        raise ValueError(f"batch {n} > {_MAX_GRID_Z} pages or page {h}x{w} >= 2^31 px")
    labels = torch.empty((n, h, w), dtype=torch.int32, device=ink.device)
    if labels.numel() == 0:
        return labels
    launch(_CC_LABEL, ink.get_device(), ink.data_ptr(), labels.data_ptr(), n, h, w)
    with _launch_lock:
        launches += LAUNCHES_PER_CALL
    return labels


# ----------------------------------------------------------- the plain version
def _shift(t, k: int, dim: int, fill, forward: bool):
    """t shifted k along dim: forward -> result[i] = t[i - k]."""
    pad_shape = list(t.shape)
    pad_shape[dim] = k
    pad = torch.full(pad_shape, fill, dtype=t.dtype, device=t.device)
    size = t.shape[dim]
    if forward:
        return torch.cat([pad, t.narrow(dim, 0, size - k)], dim)
    return torch.cat([t.narrow(dim, k, size - k), pad], dim)


def _seg_min_scan(val, blocked, dim: int, forward: bool, big: int):
    """Min-scan within contiguous unblocked runs along ``dim`` by
    Hillis-Steele doubling (``blocked`` is True on background)."""
    k = 1
    size = val.shape[dim]
    while k < size:
        upstream_val = _shift(val, k, dim, big, forward)
        upstream_blk = _shift(blocked, k, dim, True, forward)
        val = torch.where(blocked, val, torch.minimum(val, upstream_val))
        blocked = blocked | upstream_blk
        k *= 2
    return val


def cc_min_label_reference(ink: torch.Tensor, max_iters: int = _MAX_CYCLES):
    """Plain PyTorch labeler: (N, H, W) ink -> (int32 labels, cycles).

    The segmented min-scan cycles of ``cc_min_label_xla_batch`` (both
    directions of both axes) repeated to a fixed point or ``max_iters``
    cycles, on whatever device ``ink`` lies on."""
    n, h, w = ink.shape
    ink_b = ink != 0
    big = h * w + 2
    flat = torch.arange(h * w, dtype=torch.int32, device=ink.device).view(1, h, w) + 1
    labels = torch.where(ink_b, flat, big)
    not_ink = ~ink_b
    cycles = 0
    while cycles < max_iters:
        new = labels
        for dim in (2, 1):
            for forward in (True, False):
                new = _seg_min_scan(new, not_ink, dim, forward, big)
        new = torch.where(ink_b, new, big)
        cycles += 1
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return torch.where(ink_b, labels, 0).to(torch.int32), cycles


# ------------------------------------------------------------ public labelers
def _as_ink(ink, device, ndim: int) -> torch.Tensor:
    """``ink`` on ``device`` as a contiguous bool or uint8 tensor (nonzero =
    ink); a bool or uint8 tensor keeps its dtype, anything else becomes
    ``ink != 0``."""
    if not (isinstance(ink, torch.Tensor) and ink.is_cuda and on_card(ink, device)):
        ink = torch.as_tensor(ink, device=resolve_device(device))
    if ink.dim() != ndim:
        raise ValueError(f"ink must have {ndim} dims, got {tuple(ink.shape)}")
    if ink.dtype not in (torch.bool, torch.uint8):
        ink = ink != 0
    return ink.contiguous()


def _labels(ink: torch.Tensor, max_iters: int):
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if ink.device.type == "cuda":
        return _label_cuda(ink), 1  # one union-find merge pass
    return cc_min_label_reference(ink, max_iters)


def cc_min_label_batch(ink, max_iters: int = _MAX_CYCLES, device="cuda"):
    """(N, H, W) ink masks -> (int32 labels, passes); labels restart at 1
    on every page.  Counterpart of ``cc_min_label_xla_batch``.
    ``max_iters`` caps the plain version's cycles; the kernel needs no cap."""
    return _labels(_as_ink(ink, device, 3), max_iters)


def cc_min_label_xla_batch(ink, max_iters: int = _MAX_CYCLES, device="cuda"):
    """The JAX package's Pallas-free batched labeler; in the port it is
    :func:`cc_min_label_batch` (the same kernel on the card)."""
    return cc_min_label_batch(ink, max_iters, device=device)


def cc_min_label_pallas(ink, max_iters: int = _MAX_CYCLES, device="cuda"):
    """(H, W) ink mask -> (int32 labels, passes): the whole-page entry point
    (K1 on the TPU)."""
    labels, passes = _labels(_as_ink(ink, device, 2)[None], max_iters)
    return labels[0], passes


def cc_min_label_tiled(ink, band: int = 256, inner_iters: int = 128,
                       max_outer: int = 256, device="cuda"):
    """(H, W) ink mask of any size -> (int32 labels, passes): the banded
    entry point (K2 on the TPU).

    ``band``, ``inner_iters`` and ``max_outer`` tune the TPU's banding and
    are accepted for the API's sake: neither the CUDA labeler nor the plain
    version bands the page, and both give exact labels at any size."""
    labels, passes = _labels(_as_ink(ink, device, 2)[None], _MAX_CYCLES)
    return labels[0], passes


def cc_min_label(ink, device="cuda"):
    """Size-dispatching entry, as in the JAX package; on the card both
    branches launch the same kernel."""
    h, w = torch.as_tensor(ink).shape
    if h * w <= _VMEM_BUDGET_PIXELS:
        return cc_min_label_pallas(ink, device=device)
    return cc_min_label_tiled(ink, device=device)


# ------------------------------------------------------------------- the vote
def _vote_from_labels(pred, ink, labels, n_classes: int):
    """Majority class per component from per-page min-labels: one
    scatter-add histogram over (page, component, class) for the whole batch,
    argmax (first maximum, so ties go to the lowest class), gather back."""
    n, h, w = pred.shape
    comps = h * w + 1  # per-page component-id space (0 = background)
    page = torch.arange(n, device=pred.device).view(n, 1, 1)
    comp = page * comps + labels.long()
    seg = comp * n_classes + pred.long()
    counts = torch.zeros(n * comps * n_classes, dtype=torch.int32, device=pred.device)
    counts.scatter_add_(0, seg.flatten(), ink.to(torch.int32).flatten())
    majority = counts.view(n * comps, n_classes).argmax(dim=1).to(pred.dtype)
    return torch.where(ink, majority[comp], pred)


def cc_vote_batch(pred, binary, n_classes: int, device="cuda"):
    """Batched cc-majority vote: (N, H, W) class map + ink -> voted class
    map, labels by the kernel on the card."""
    with span("ps.vote"):
        dev = resolve_device(device)
        pred = torch.as_tensor(pred, device=dev)
        ink = _as_ink(binary, dev, 3)
        labels, _ = _labels(ink, _MAX_CYCLES)
        return _vote_from_labels(pred, ink if ink.dtype == torch.bool else ink != 0, labels,
                                 n_classes)


def cc_vote_batch_xla(pred, binary, n_classes: int, device="cuda"):
    """The JAX package's Pallas-free batched vote; in the port it is
    :func:`cc_vote_batch` (same kernel, same histogram)."""
    return cc_vote_batch(pred, binary, n_classes, device=device)


def cc_vote_pallas(pred, binary, n_classes: int, device="cuda"):
    """One-page cc-majority vote: (H, W) class map + ink."""
    dev = resolve_device(device)
    pred = torch.as_tensor(pred, device=dev)
    return cc_vote_batch(pred[None], torch.as_tensor(binary, device=dev)[None],
                         n_classes, device=dev)[0]
