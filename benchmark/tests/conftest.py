"""Small cells for the CPU tests: each real cell of ``BENCHMARK.json`` with
its pages cut to 512 x 384, a few of them, and small batches."""
from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

SMALL = {
    "corpus": dict(page_shape=[512, 384], pool_pages=8, warmup_batches=2, control_pages=4),
}
SEED = 2 ** 31 + 12345  # above 32 signed bits: seeds that large must work


def small_cell(name: str, float32: bool = True):
    cell = harness.load_cell(name)
    cell.traffic.update(SMALL[cell.traffic["driver"]])
    if "predict" in cell.config:
        cell.config["predict"]["batch"] = 4
        if float32:  # the CPU's float32 equals the reference's
            cell.config["predict"]["dtype"] = "float32"
    return cell


def run_small(cell, seconds: float = 1.5, control: bool = False, device: str = "cpu",
              seed: int = SEED):
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device,
                      control=control, t_process=time.perf_counter())
    harness.driver(cell.traffic["driver"]).run(run)
    metrics = harness.read_metrics(run, cell.end_to_end)
    return run, harness.result_line(run, metrics, {}, None)

