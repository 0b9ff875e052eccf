"""The yardstick's arithmetic against worked examples."""
from __future__ import annotations

import statistics

import pytest

from benchmark import arith, tracing


def test_flops_of_one_convolution_by_hand():
    # a 3x3 SAME convolution, 2 -> 5 channels, on 1 x 2 x 4 x 6: every
    # output pixel takes 2 * 9 multiply-adds per output channel
    assert arith.forward_flops("fcn_skip", 3, (1, 1, 8, 8)) > 0
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference.models import conv

    with torch.device("meta"):
        x, w = torch.empty(1, 2, 4, 6), torch.empty(5, 2, 3, 3)
    with FlopCounterMode(display=False) as counter:
        conv(x, w)
    assert counter.get_total_flops() == 2 * (5 * 4 * 6) * (2 * 9)


@pytest.mark.parametrize("arch,shape,gflop", [
    ("fcn_skip", (1, 1, 424, 304), 14.6554752),      # chip_smoke family_gflop_per_page
    ("effb7", (1, 3, 448, 320), 129.856134144),      # the same count, PERF.md's table
    ("fcn_skip", (48, 1, 424, 304), 48 * 14.6554752),  # a batch counts each page
])
def test_flops_of_the_cells(arch, shape, gflop):
    assert arith.forward_flops(arch, 3, shape) / 1e9 == pytest.approx(gflop, rel=1e-9)


def test_vote_bytes_and_roofline():
    # 48 pages of 424 x 304: 6,187,008 px at 2.125 B = 13,147,392 B
    assert arith.vote_bytes(48, (424, 304)) == pytest.approx(48 * 424 * 304 * 2.125)
    least = arith.vote_bytes(48, (424, 304)) / arith.HBM_BYTES_PER_S
    assert least == pytest.approx(13_147_392 / 3.35e12) == pytest.approx(3.92459e-6, rel=1e-5)
    assert arith.roofline_share(least, 4 * least) == pytest.approx(25.0)


def test_mfu_worked_example():
    # 300 pages/s of 14.6554752 GFLOP at the bf16 peak of 989 TFLOP/s = 0.4446 %:
    # 25 batches of 48 inside a traced sub-window of 4 s
    from benchmark import harness, readers

    run = harness.Run(cell=harness.load_cell("fcnskip.corpus"), seed=1, seconds=20.0, trace=True)
    run.profile = tracing.Profile()
    run.profile.t_start, run.profile.t_stop, run.profile.units = 5.0, 9.0, 25
    run.values["flop_per_batch"] = 48 * 14.6554752e9
    assert readers.mfu_pct(run, "flop_per_batch", "bfloat16") == pytest.approx(
        100 * 300 * 14.6554752e9 / 989e12)


def test_mfu_ignores_the_profilers_cost_to_the_whole_windows_rate():
    """The traced run's whole-window rate pays for the profiler's start and
    stop; mfu reads the sub-window only, so the slower whole window does
    not move it."""
    from benchmark import harness, readers

    run = harness.Run(cell=harness.load_cell("fcnskip.corpus"), seed=1, seconds=20.0, trace=True)
    run.values["flop_per_batch"] = 1e12
    assert readers.mfu_pct(run, "flop_per_batch", "bfloat16") is None  # no profile
    run.profile = tracing.Profile()
    run.profile.t_start, run.profile.t_stop, run.profile.units = 5.0, 9.0, 40
    run.counts["pages"], run.window_s = 48 * 60, 20.0  # half the sub-window's rate
    assert readers.mfu_pct(run, "flop_per_batch", "bfloat16") == pytest.approx(
        100 * 10 * 1e12 / 989e12)


def test_busy_time_is_the_union_of_intervals():
    assert arith.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == pytest.approx(4.0)
    assert arith.busy_us([]) == 0.0
    assert arith.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [(0, 1), (3, 5), (6, 8)]


def test_idle_share_of_a_profile():
    p = tracing.Profile()
    p.t_start, p.t_stop = 10.0, 12.0
    p.intervals = [(9.5, 10.5), (11.0, 11.25), (11.9, 12.4)]  # clipped to the window
    assert p.busy_s == pytest.approx(0.5 + 0.25 + 0.1)
    assert p.idle_share == pytest.approx(1 - 0.85 / 2)
    spans = tracing.Spans()
    spans.add("prep_batch", 10.4, 11.2)
    gaps = p.breakdown(spans)["idle_gaps"]
    assert gaps == [["no benchmark span", pytest.approx(0.65)], ["prep_batch", pytest.approx(0.5)]]


def test_spread_uses_pythons_quartiles():
    values = [100.0, 101.0, 99.0, 102.0, 98.0, 100.5]
    q1, q2, q3 = statistics.quantiles(values, n=4)
    assert arith.spread(values) == pytest.approx((q3 - q1) / q2)
    assert arith.spread([1.0, 1.0, 1.0, 1.0]) == 0.0


def test_span_means_cover_the_window_only():
    spans = tracing.Spans()
    for s, e in [(0.0, 0.1), (1.0, 1.02), (2.0, 2.04), (9.0, 9.5)]:
        spans.add("prep_batch", s, e)
    assert spans.mean_ms("prep_batch", 0.5, 3.0) == pytest.approx(30.0)
    assert spans.mean_ms("download_finish", 0.5, 3.0) is None
    # a span across the profiler's own start or stop is left out
    assert spans.mean_ms("prep_batch", 0.5, 3.0, exclude=[(2.01, 2.5)]) == pytest.approx(20.0)
    assert spans.mean_ms("prep_batch", 0.5, 3.0, exclude=[(0.5, 3.0)]) is None
