"""Shared arithmetic of the per-metric readers under ``metrics/``.

Each reader returns None where its run has nothing to read: a metric of
spans or of the trace needs ``--trace 1``, and a share of a peak or a
roofline is never made up as 0."""
from __future__ import annotations

from typing import Optional

from . import arith


def rate(run, count: str) -> Optional[float]:
    if count not in run.counts or not run.window_s:
        return None
    return run.counts[count] / run.window_s


def span_mean_ms(run, name: str) -> Optional[float]:
    if run.spans is None or run.t_window is None:
        return None
    exclude = run.profile.host_busy if run.profile is not None else ()
    return run.spans.mean_ms(name, run.t_window, run.t_window + run.window_s, exclude)


def idle_share_pct(run) -> Optional[float]:
    if run.profile is None or run.profile.t_stop is None:
        return None
    return 100.0 * run.profile.idle_share


def device_ms_per_unit(run) -> Optional[float]:
    p = run.profile
    if p is None or p.t_stop is None or not p.units:
        return None
    return 1e3 * p.busy_s / p.units


def mfu_pct(run, flops_key: str, peak: str) -> Optional[float]:
    """% of ``peak``: the batches completed inside the traced sub-window
    times ``run.values[flops_key]`` FLOPs a batch, over the
    sub-window's seconds.  The traced run's rate over its whole window
    would count the profiler's own start and stop against the program."""
    p = run.profile
    if p is None or p.t_stop is None or not p.units or flops_key not in run.values:
        return None
    return 100.0 * p.units * run.values[flops_key] / p.window_s / arith.PEAK_FLOPS[peak]
