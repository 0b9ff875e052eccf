"""Tracing and timing helpers.

Counterpart of ``page_segmentation_tpu/train/profiling.py`` on PyTorch::

    with trace("/tmp/torch-trace"):   # a Chrome trace in the directory
        run_steps()

    stats = time_fn(lambda: step(batch), iters=10)
    print(stats["mean_ms"], stats["items_per_sec"])

Times are host clock around work that ends in ``torch.cuda.synchronize()``
when a card is present, so they cover the device's work.

The program's own spans and counters (port-only).  The corpus path opens
``ps.*`` spans around its stages (``inference/pipeline.py``: ``ps.prep``,
``ps.decimate``, ``ps.wait_prep``, ``ps.launch``, ``ps.forward``,
``ps.finish``, ``ps.wait_download``, ``ps.trio``; ``ops/cuda_cc.py``:
``ps.vote``) and counts ``ps.decimate_bytes`` and ``ps.decimate_threads``
(the threads each decimate used).  The train path opens ``ps.step`` (unit:
the global step), ``ps.batch_wait``, ``ps.fwd_bwd`` and ``ps.optim``
(``train/trainer.py``, ``train/steps.py``) and ``ps.dropout``
(``ops/prng.py``), and counts ``ps.dropout_bytes``, the bytes each dropout
pass reads and writes, forward and backward.  The recorder is off by
default, and then a span is one flag check.  ``trace()`` turns it on for
its block, so the Chrome trace carries the ``ps.*`` names beside the
kernels they launched.  A process with no profiler reads the recorder
itself::

    enable_spans()
    for trio in predictor.run(pages, binaries, batch_size=48):
        ...
    disable_spans()
    prep_ms = [1e3 * (s.end - s.start) for s in spans() if s.name == "ps.prep"]
    read_bytes = counters()["ps.decimate_bytes"]

A span's times are ``time.perf_counter()`` seconds, the host clock onto
which a profiler's events can be mapped through one mark.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, NamedTuple, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


# ------------------------------------------------------- spans and counters
class Span(NamedTuple):
    """One closed span: ``start`` and ``end`` in ``time.perf_counter()``
    seconds, the thread's ``threading.get_ident()``, the id of the span
    that enclosed it on that thread (None at the top) and its ``unit`` (a
    batch index, say), its parent's where it was given none."""

    id: int
    name: str
    start: float
    end: float
    thread: int
    parent: Optional[int]
    unit: Optional[int]


_NULL_SPAN = contextlib.nullcontext()
_CAPACITY = 65536  # spans the ring keeps: ~6500 batches of the corpus path
_enabled = False
_lock = threading.Lock()
_records: deque = deque(maxlen=_CAPACITY)
_counters: Dict[str, float] = {}
_ids = itertools.count(1)
_open = threading.local()  # .stack: (id, unit) of the spans open on this thread


class _OpenSpan:
    __slots__ = ("name", "unit", "id", "parent", "start", "_range")

    def __init__(self, name: str, unit):
        self.name, self.unit = name, unit

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.id = next(_ids)
        self.parent = stack[-1][0] if stack else None
        if self.unit is None and stack:
            self.unit = stack[-1][1]
        stack.append((self.id, self.unit))
        self.start = time.perf_counter()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        end = time.perf_counter()
        _open.stack.pop()
        record = Span(self.id, self.name, self.start, end, threading.get_ident(),
                      self.parent, self.unit)
        with _lock:
            _records.append(record)
        return False


def span(name: str, unit: Optional[int] = None):
    """Context manager: a span of the program.  Off, the shared null
    context: nothing is recorded or opened.  On, it records a ``Span`` when
    the block ends and opens ``torch.profiler.record_function(name)``, so a
    running profiler attributes the kernels the block launched to it."""
    if not _enabled:
        return _NULL_SPAN
    return _OpenSpan(name, unit)


def count(name: str, n: float) -> None:
    """Add ``n`` to the cumulative counter ``name`` (nothing while off)."""
    if not _enabled:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def enable_spans() -> None:
    """Start a new recording: the ring keeps the last ``_CAPACITY`` spans;
    counters start at 0."""
    global _enabled, _records
    with _lock:
        _records = deque(maxlen=_CAPACITY)
        _counters.clear()
        _enabled = True


def disable_spans() -> None:
    """Stop recording; what was recorded stays readable."""
    global _enabled
    _enabled = False


def spans() -> List[Span]:
    """The recorded spans, in the order they closed."""
    with _lock:
        return list(_records)


def counters() -> Dict[str, float]:
    """The counters' totals since the recording started."""
    with _lock:
        return dict(_counters)


def _all_threads_config():
    """The profiler's experimental config that records every thread, or
    None on a torch whose profiler has no ``profile_all_threads``."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(logdir: str):
    """``torch.profiler`` over the block (the card's kernels too, when there
    is one), with the program's span recorder on (left as it was, if it was
    on already); the Chrome trace lands in ``logdir``/trace.json.  Every
    thread's ops and spans reach it; on a torch whose profiler has no
    ``profile_all_threads``, only the calling thread's (``run()``'s
    ``ps.wait_prep``, ``ps.launch`` and their children, not those of its
    prefetch and downloader threads)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    was_on = _enabled
    if not was_on:
        enable_spans()
    try:
        with profile(activities=activities, experimental_config=_all_threads_config()) as prof:
            try:
                yield prof
            finally:
                _sync()
    finally:
        if not was_on:
            disable_spans()
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
