"""Device resolution for the port's entry points.

Every entry point takes ``device="cuda"`` by default and runs on the card.
The CPU is used only when the caller asks for it (``device="cpu"``), as the
tests do; a request for CUDA on a machine without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def on_card(x: torch.Tensor, device="cuda") -> bool:
    """True when the CUDA tensor ``x`` already lies where ``device`` names,
    so an entry point may take it as it is, without :func:`resolve_device`:
    ``device`` is CUDA with no index (then it names whichever card ``x`` is
    on) or with ``x``'s index."""
    if type(device) is not torch.device:
        if device == "cuda":
            return True
        device = torch.device(device)
    index = device.index
    return device.type == "cuda" and (index is None or index == x.get_device())
