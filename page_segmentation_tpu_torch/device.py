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
