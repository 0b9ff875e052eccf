"""Tracing and timing helpers.

Counterpart of ``page_segmentation_tpu/train/profiling.py`` on PyTorch::

    with trace("/tmp/torch-trace"):   # a Chrome trace in the directory
        run_steps()

    stats = time_fn(lambda: step(batch), iters=10)
    print(stats["mean_ms"], stats["items_per_sec"])

Times are host clock around work that ends in ``torch.cuda.synchronize()``
when a card is present, so they cover the device's work.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too, when there
    is one); the Chrome trace lands in ``logdir``/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def time_fn(
    fn: Callable[[], object],
    iters: int = 10,
    warmup: int = 2,
    items_per_call: int = 1,
) -> dict:
    """Wall clock of ``fn`` per call, synchronized with the card."""
    for _ in range(warmup):
        fn()
    _sync()
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        fn()
        _sync()
        times.append(time.perf_counter() - start)
    mean = sum(times) / len(times)
    return {
        "mean_ms": mean * 1e3,
        "min_ms": min(times) * 1e3,
        "max_ms": max(times) * 1e3,
        "items_per_sec": items_per_call / mean if mean > 0 else float("inf"),
        "times": times,
    }


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of the card (current and peak bytes, ...),
    or None off the card."""
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return None
    return torch.cuda.memory_stats(device)
