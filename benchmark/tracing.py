"""Spans from the benchmark's own files and a bounded device trace.

``Spans`` times calls into the program's layers on the host clock: it
wraps an instance's method (or a module's function) so that every call
records (name, start, end) and, while the profiler runs, opens a
``torch.profiler.record_function`` of the same name, so the device work a
call launched can be attributed to it.

``Profile`` runs ``torch.profiler`` over a fixed sub-window of the
measured window, so its cost and its trace stay small, and reduces it to:
the union of the device's busy intervals (``arith.busy_us``), device time
by operation, device time under each span name, and the longest idle gaps
named by the spans that were open on the host meanwhile.
"""
from __future__ import annotations

import functools
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from . import arith


class Spans:
    def __init__(self):
        self._lock = threading.Lock()
        self.records: List[Tuple[str, float, float]] = []

    def add(self, name: str, start: float, end: float) -> None:
        with self._lock:
            self.records.append((name, start, end))

    def wrap(self, owner, attr: str, name: str) -> None:
        import torch

        inner = getattr(owner, attr)

        @functools.wraps(inner)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(name):
                    return inner(*args, **kwargs)
            finally:
                self.add(name, t0, time.perf_counter())

        setattr(owner, attr, timed)

    def between(self, name: str, start: float, end: float) -> List[Tuple[float, float]]:
        """(start, end) of the ``name`` spans that ended in [start, end]."""
        return [(s, e) for n, s, e in self.records if n == name and start <= e <= end]

    def mean_ms(self, name: str, start: float, end: float,
                exclude: Sequence[Tuple[float, float]] = ()) -> Optional[float]:
        """Mean ms of the ``name`` spans that ended in [start, end] and
        overlap none of the ``exclude`` intervals."""
        spans = [(s, e) for s, e in self.between(name, start, end)
                 if not any(s < x1 and x0 < e for x0, x1 in exclude)]
        if not spans:
            return None
        return 1e3 * sum(e - s for s, e in spans) / len(spans)

    def open_at(self, t: float) -> List[str]:
        return sorted({n for n, s, e in self.records if s <= t <= e})


def _launched_us(event, range_name: str) -> float:
    """Device µs of the kernels launched under a host event and its
    children, without the range's own GPU annotation (which spans the
    gaps between its kernels)."""
    own = sum(k.duration for k in event.kernels if k.name != range_name)
    return own + sum(_launched_us(c, range_name) for c in event.cpu_children)


class Profile:
    """torch.profiler from ``start()`` to ``stop()``; times in seconds on
    the host's ``perf_counter`` clock."""

    def __init__(self, ranges=()):
        self.ranges = set(ranges)  # span names whose device time is summed
        self.t_start = self.t_stop = None
        self.intervals: List[Tuple[float, float]] = []
        self.by_op: Dict[str, float] = {}
        self.by_range: Dict[str, float] = {}
        self.range_calls: Dict[str, int] = {}
        self._prof = None
        self.units = 0  # batches, steps or requests completed inside
        self.host_busy: List[Tuple[float, float]] = []  # the profiler's own start and stop

    @staticmethod
    def prime() -> None:
        """Start and stop the profiler once around a small device op, in
        set-up: its first start (CUPTI's) takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        t_call = time.perf_counter()
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        with torch.profiler.record_function("benchmark_clock"):
            self._mark = time.perf_counter()
        self.t_start = time.perf_counter()
        self.host_busy.append((t_call, self.t_start))

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        mark = next(e for e in events if e.name == "benchmark_clock")
        offset = self._mark - mark.time_range.start / 1e6
        # device work: kernels, copies and sets, not the ranges' GPU annotations
        device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)]
        self.intervals = [(e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset)
                          for e in device]
        by_op: Dict[str, float] = defaultdict(float)
        for e in device:
            by_op[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        self.by_op = dict(by_op)
        by_range: Dict[str, float] = defaultdict(float)
        calls: Dict[str, int] = defaultdict(int)
        for e in events:
            if e.name in self.ranges and e.device_type == torch.autograd.DeviceType.CPU:
                by_range[e.name] += _launched_us(e, e.name) / 1e6
                calls[e.name] += 1
        self.by_range, self.range_calls = dict(by_range), dict(calls)
        self._prof = None
        self.host_busy.append((self.t_stop, time.perf_counter()))

    @property
    def window_s(self) -> float:
        return self.t_stop - self.t_start

    @property
    def busy_s(self) -> float:
        clipped = [(max(s, self.t_start), min(e, self.t_stop)) for s, e in self.intervals]
        return arith.busy_us([c for c in clipped if c[1] > c[0]])

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def breakdown(self, spans: Optional[Spans], top: int = 10) -> dict:
        ops = sorted(self.by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(arith.idle_gaps(self.intervals, self.t_start, self.t_stop),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            host = spans.open_at((s + e) / 2) if spans is not None else []
            named.append(["+".join(host) or "no benchmark span", e - s])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


class Window:
    """Starts and stops a ``Profile`` at fixed offsets in the measured
    window; a cell's ``drivers/`` module calls ``tick()`` as it runs."""

    def __init__(self, run, start_frac: float = 0.3, seconds: float = 3.0, ranges=()):
        self.run = run
        self.start_frac, self.length = start_frac, seconds
        self.profile = Profile(ranges) if run.trace else None
        run.profile = self.profile
        if self.profile is not None:
            Profile.prime()
        self._state = 0  # 0 waiting, 1 profiling, 2 done

    def tick(self, unit_done: bool = False) -> None:
        if self.profile is None or self._state == 2:
            return
        now = time.perf_counter()
        t0 = self.run.t_window + self.start_frac * self.run.seconds
        if self._state == 0 and now >= t0:
            self.profile.start()  # the profiler's own start-up comes before t_start
            self._state = 1
        elif self._state == 1:
            if unit_done:
                self.profile.units += 1
            length = min(self.length, (1 - self.start_frac) * self.run.seconds * 0.8)
            if now >= self.profile.t_start + length:
                self.profile.stop()
                self._state = 2

    def close(self) -> None:
        if self.profile is not None and self._state == 1:
            self.profile.stop()
            self._state = 2
