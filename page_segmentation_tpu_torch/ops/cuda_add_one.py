"""``x + 1`` on int32: the elementwise kernel of the download-race tool.

Counterpart of the Pallas kernel in ``tools/repro_pallas_download.py``
(``kernel``, called through ``with_pallas``), which casts its input to int32
and adds one.  Two implementations of that function:

* the hand-written CUDA kernel ``csrc/add_one.cu``, launched for tensors on
  the card;
* :func:`add_one_reference`, the plain PyTorch version, which tensors on the
  CPU take.

A CUDA tensor launches the kernel or raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..device import resolve_device

# kernel launches of csrc/add_one.cu made by this process
launches = 0
_launch_lock = threading.Lock()


def _lib():
    from .._kernels import KERNELS, load_library

    lib = load_library(KERNELS["add_one"])
    if not getattr(lib, "_ps_typed", False):
        vp = ctypes.c_void_p
        lib.ps_add_one.argtypes = [vp, vp, ctypes.c_longlong, vp]
        lib.ps_add_one.restype = ctypes.c_int
        lib._ps_typed = True
    return lib


def _add_one_cuda(x: torch.Tensor) -> torch.Tensor:
    """int32 ``x + 1`` by the kernel, on the current stream."""
    global launches
    if x.device.type != "cuda":
        raise ValueError(f"_add_one_cuda needs a CUDA tensor, got {x.device}")
    x = x.to(torch.int32).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
        rc = lib.ps_add_one(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                            x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"add_one launch failed: CUDA error {rc}")
    with _launch_lock:
        launches += 1
    return out


def add_one_reference(x) -> torch.Tensor:
    """Plain PyTorch version: ``x`` cast to int32, plus one, on ``x``'s device."""
    return torch.as_tensor(x).to(torch.int32) + 1


def add_one(x, device="cuda") -> torch.Tensor:
    """int32 ``x + 1`` on ``device``: the kernel for a tensor on the card,
    the plain version for one on the CPU."""
    x = torch.as_tensor(x, device=resolve_device(device))
    if x.device.type == "cuda":
        return _add_one_cuda(x)
    return add_one_reference(x)
