"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (page pool, weights, the program's
build and warm-up) counts into ``setup_s``; the window measures for
``--seconds``; then the reference checks what the window produced.  With
``--trace 0`` the result line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time.  A run that
finds no CUDA card, or fewer than the cell asks for, fails and prints no
result; so does one after which JAX or the JAX package is loaded.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from benchmark import harness  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="run the cell's precision control in the program's place")
    return p.parse_args(argv)


def execute(args):
    """Run the cell on the card; returns (Run, metrics, breakdown)."""
    cell = harness.load_cell(args.workload)
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      control=args.control, t_process=T_PROCESS)
    harness.driver(cell.traffic["driver"]).run(run)
    metrics = harness.read_metrics(run, cell.per_layer if run.trace else cell.end_to_end)
    breakdown = run.profile.breakdown(run.spans) if run.trace and run.profile else None
    return run, metrics, breakdown


def main(argv=None) -> int:
    args = parse(argv)
    harness.set_cache_env()
    import torch

    chips = harness.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {chips} CUDA card(s), found {n}: no result", file=sys.stderr)
        return 2
    run, metrics, breakdown = execute(args)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}: no result", file=sys.stderr)
        return 3
    line = harness.result_line(run, metrics, harness.device_record(run), breakdown)
    harness.print_checks(run)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
