"""Each cell's run, driven on the CPU at a small size without the harness's
look for a card, comes out correct as it stands and not correct with each
fault the cell can have planted in its timed path: an answer altered where
it is produced.  (The cells run on one card and hold no training step: no
exchange between cards, no half batch and no state to leave unchanged.)"""
from __future__ import annotations

import numpy as np
import pytest

from .conftest import run_small, small_cell


def _alter_answers(monkeypatch):
    """Every page's color: text painted as image, where the trio is made."""
    from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor

    finish = ThroughputPredictor._finish

    def altered(self, downloaded, ink):
        out = list(finish(self, downloaded, ink))
        color = out[-3]
        text = (color == np.uint8([255, 0, 0])).all(axis=-1)
        color[text] = np.uint8([0, 255, 0])
        return tuple(out)

    monkeypatch.setattr(ThroughputPredictor, "_finish", altered)


CASES = [
    ("fcnskip.corpus", None), ("fcnskip.corpus", _alter_answers),
    ("effb7.corpus", None), ("effb7.corpus", _alter_answers),
]


@pytest.mark.parametrize("cell,fault", CASES,
                         ids=[f"{c}-{f.__name__.strip('_') if f else 'sound'}" for c, f in CASES])
def test_a_fault_in_the_timed_path_makes_the_run_not_correct(cell, fault, monkeypatch):
    if fault is not None:
        fault(monkeypatch)
    run, line = run_small(small_cell(cell), seconds=1.0)
    assert line["correct"] is (fault is None), line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
