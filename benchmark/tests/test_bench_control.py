"""Each cell's precision control comes out not correct: the program's own
int8 path for the bf16 FCNSkip predict path or, where the program has none
(EfficientNet-B7), the reference in float8 in the program's place.  The
control needs the card:

    python -m pytest -q -m cuda benchmark/tests/test_bench_control.py

runs each cell at its own size, with a 3 s window, on three seeds;
``PERF.md`` gives the readings."""
from __future__ import annotations

import pytest

from benchmark import harness

from .conftest import run_small

CELLS = ["fcnskip.corpus", "effb7.corpus"]
SEEDS = [2 ** 31 + 17, 2 ** 32 + 5, 41]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_the_precision_control_is_not_correct(name, seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs on a CUDA card")
    run, line = run_small(harness.load_cell(name), seconds=3.0, control=True, device="cuda", seed=seed)
    assert line["correct"] is False, line["checks"]
