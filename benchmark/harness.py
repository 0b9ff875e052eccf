"""The harness: finds a cell's files by name and runs it once.

Everything that belongs to one piece sits in a file of its own, found by
the name ``BENCHMARK.json`` gives it:

* ``workloads/<cell>.json``: the configuration and traffic names, the
  cell's own parameters (a decisive margin, say) and the limits of its
  correctness numbers;
* ``configs/<config>.json``: the model and the deployment's settings;
* ``mixes/<traffic>.json``: the mix's parameters and the ``drivers/`` module it feeds;
* ``drivers/<driver>.py``: ``run(ctx)`` sets up, measures the window and
  checks what it produced against the reference;
* ``metrics/<metric>.py``, or else ``metrics/<kind>.py`` for a metric named
  ``<kind>.<qualifier>``: ``read(run)`` returns one metric's value, or
  None where the run has nothing for it to read.

A run prints, last on standard output, one JSON line with ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number with its limit,
which also close standard error.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "page_segmentation_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver(name: str, here: Path = HERE):
    return _load_module(here / "drivers" / f"{name}.py", f"benchmark_driver_{name}")


def metric_reader(name: str, here: Path = HERE) -> Callable:
    """``metrics/<name>.py``, or else the reader of the metric's kind, the
    part of the name before the first dot (``metrics/pages_per_s.py`` for
    ``pages_per_s.fcnskip``)."""
    path = here / "metrics" / f"{name}.py"
    if not path.exists():
        path = here / "metrics" / f"{name.split('.', 1)[0]}.py"
    module = _load_module(path, "benchmark_metric_" + path.stem.replace(".", "_"))
    return module.read


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def chips(self) -> int:
        return int(self.workload.get("chips", 1))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT, here: Path = HERE) -> Cell:
    spec = benchmark_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = {**load_json(here / "workloads" / f"{name}.json"), **entry}
    config = load_json(here / "configs" / f"{entry['config']}.json")
    traffic = load_json(here / "mixes" / f"{entry['traffic']}.json")
    return Cell(name, workload, config, traffic,
                [m for m in spec["end_to_end"] if _reports(m, name)],
                [m for m in spec["per_layer"] if _reports(m, name)])


def forbidden_loaded(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (whole, before the first dot)
    that the benchmark may not load."""
    tops = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value is not None and math.isfinite(self.value) and self.value <= self.limit


@dataclass
class Run:
    """What a driver hands to the metric readers."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    control: bool = False
    t_process: float = 0.0
    t_window: Optional[float] = None
    window_s: Optional[float] = None
    counts: Dict[str, float] = field(default_factory=dict)
    values: Dict[str, Any] = field(default_factory=dict)
    checks: List[Check] = field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    spans: Any = None
    profile: Any = None

    @property
    def setup_s(self) -> Optional[float]:
        return None if self.t_window is None else self.t_window - self.t_process

    def limit(self, name: str) -> float:
        return float(self.cell.workload["limits"][name])

    def check(self, name: str, value: float) -> None:
        self.checks.append(Check(name, float(value), self.limit(name)))

    # ------------------------------------------------------------ window
    def window_start(self, t: Optional[float] = None) -> float:
        """Mark the window's start (set-up ends here); the device's peak
        memory is counted from here."""
        import torch

        self.t_window = time.perf_counter() if t is None else t
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        return self.t_window

    def window_closed(self) -> None:
        """Read the device's peak before anything else runs on it."""
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def device_record(run: Run) -> dict:
    import torch

    record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips, "memory_peak_bytes": run.memory_peak_bytes}
    if run.trace and run.profile is not None:
        record["busy_s"] = run.profile.busy_s
        record["window_s"] = run.profile.window_s
    return record


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> dict:
    checks = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    correct = bool(run.checks) and all(c.ok for c in run.checks) and run.failed == 0
    line = {"correct": correct, "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    return line


def read_metrics(run: Run, entries: List[dict], here: Path = HERE) -> Dict[str, dict]:
    out = {}
    for m in entries:
        value = metric_reader(m["name"], here)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def print_checks(run: Run, stream=sys.stderr) -> None:
    for c in run.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=stream)
    if run.failed:
        print(f"check failed_requests {run.failed} limit 0 FAILED", file=stream)


def cache_dirs(root: Path = ROOT) -> Dict[str, str]:
    """Fixed cache directories inside the checkout for any compiler the
    program may use (its own libraries build into its package's
    ``_build/``)."""
    base = root / "benchmark" / "_cache"
    return {"TRITON_CACHE_DIR": str(base / "triton"),
            "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions")}


def set_cache_env() -> None:
    for key, value in cache_dirs().items():
        os.environ[key] = value
