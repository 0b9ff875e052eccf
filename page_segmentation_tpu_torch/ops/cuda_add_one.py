"""``x + 1`` on int32: the elementwise kernel of the download-race tool.

Counterpart of the Pallas kernel in ``tools/repro_pallas_download.py``
(``kernel``, called through ``with_pallas``), which casts its input to int32
and adds one.  Two implementations of that function:

* the hand-written CUDA kernel ``csrc/add_one.cu`` (16 B a thread), launched
  for tensors on the card;
* :func:`add_one_reference`, the plain PyTorch version, which tensors on the
  CPU take.

The launch path is lean, because the host's Python, not the card, sets the
time of so small a kernel: :func:`add_one` hands a CUDA tensor straight to
:func:`_add_one_cuda`, which casts or copies only what is not int32 and
contiguous, allocates with ``torch.empty_like`` and launches through
``_kernels.launch`` (the C entry bound once, the raw current stream, a
device guard only off the current card).

A CUDA tensor launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from .._kernels import Entry, launch
from ..device import on_card, resolve_device

# kernel launches of csrc/add_one.cu made by this process
launches = 0
_launch_lock = threading.Lock()

_ADD_ONE = Entry("add_one", "ps_add_one", (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong))
_CUDA = torch.device("cuda")  # names whichever card a CUDA tensor is on (device.on_card)


def _add_one_cuda(x: torch.Tensor) -> torch.Tensor:
    """int32 ``x + 1`` by the kernel, on the current stream."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"_add_one_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype is not torch.int32 or not x.is_contiguous():
        x = x.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    n = x.numel()
    if n:
        launch(_ADD_ONE, x.get_device(), x.data_ptr(), out.data_ptr(), n)
        with _launch_lock:
            launches += 1
    return out


def add_one_reference(x) -> torch.Tensor:
    """Plain PyTorch version: ``x`` cast to int32, plus one, on ``x``'s device."""
    return torch.as_tensor(x).to(torch.int32) + 1


def add_one(x, device="cuda") -> torch.Tensor:
    """int32 ``x + 1`` on ``device``: the kernel for a tensor on the card,
    the plain version for one on the CPU.  A CUDA tensor that already lies
    where ``device`` names (see ``device.on_card``) goes to the kernel as it
    is."""
    if type(x) is torch.Tensor and x.is_cuda and (device == _CUDA or on_card(x, device)):
        return _add_one_cuda(x)
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.device.type == "cuda":
        return _add_one_cuda(x)
    return add_one_reference(x)
