"""The benchmark's training cells end to end on the CPU, small: each cell
of ``BENCHMARK.json`` that the ``train`` mix drives, found by
``harness.load_cell`` and run by ``drivers/train.py`` with its pages cut to
512 x 384 (64 x 48 padded), a pool of 8 and batch 2, as
``benchmark/tests/conftest.py`` cuts the corpus cells.  A traced run's line
carries the cell's end-to-end and per-layer metrics and its checks, and is
correct; the precision control's is not.  On the CPU the profiler sees no
device: its CUDA calls are stubbed, and the dropout kernel's roofline,
which reads the kernel's device time, is left out."""
import json
import time

import pytest
import torch

from benchmark import harness, tracing

CELLS = ["unet.train"]
SEED = 2 ** 31 + 12345  # above 32 signed bits: seeds that large must work
CARD_ONLY = {"dropout_roofline.unet"}


@pytest.fixture(autouse=True)
def _cpu_profile(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(tracing.Profile, "prime", staticmethod(lambda: None))


def small_cell(name: str):
    cell = harness.load_cell(name)
    cell.traffic.update(page_shape=[512, 384], pool_pages=8, warmup_steps=3)
    cell.workload["batch"] = 2
    return cell


def run_small(name: str, trace: bool, control: bool = False, seconds: float = 2.0):
    cell = small_cell(name)
    run = harness.Run(cell=cell, seed=SEED, seconds=seconds, trace=trace, device="cpu",
                      control=control, t_process=time.perf_counter())
    harness.driver(cell.traffic["driver"]).run(run)
    metrics = harness.read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    line = harness.result_line(run, metrics, {}, None)
    return cell, run, json.loads(json.dumps(line))


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_carries_every_metric_and_is_correct(name):
    cell, run, line = run_small(name, trace=True)
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == {"grad_tf32_ratio", "update_rel_err"}
    want = {m["name"] for m in cell.per_layer} - CARD_ONLY
    assert want <= set(line["metrics"]), want - set(line["metrics"])
    config = cell.config["name"]
    assert {f"train_step_ms.{config}", f"batch_wait_ms.{config}", f"optim_device_ms.{config}",
            f"train_mfu.{config}"} <= want
    assert 0 < line["metrics"][f"train_mfu.{config}"]["value"] < 100
    assert line["attempted"] == run.counts["steps"] > 0 and line["failed"] == 0
    assert run.values["pad_shape"] == (64, 48)


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_reports_the_end_to_end_metrics(name):
    cell, run, line = run_small(name, trace=False)
    assert line["correct"] is True, line["checks"]
    assert {m["name"] for m in cell.end_to_end} == set(line["metrics"])
    assert {"setup_s", "pages_per_s.effb7"} == set(line["metrics"])
    rate = line["metrics"]["pages_per_s.effb7"]
    assert rate["value"] == run.counts["pages"] / run.window_s > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_is_not_correct(name):
    _, _, line = run_small(name, trace=False, control=True)
    assert line["correct"] is False
    assert line["checks"]["grad_tf32_ratio"]["value"] > line["checks"]["grad_tf32_ratio"]["limit"]


def test_weights_that_never_change_are_not_correct(monkeypatch):
    """A trainer whose copy of the new weights into the module does nothing
    feeds the first weights to every step; the gradient the step took is
    still the reference's from those weights, but the weights' change reads
    1, over its limit."""
    from page_segmentation_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(Trainer, "_assign", lambda self, params, state=None: None)
    _, _, line = run_small("unet.train", trace=False)
    checks = line["checks"]
    assert line["correct"] is False
    assert checks["grad_tf32_ratio"]["value"] <= checks["grad_tf32_ratio"]["limit"]
    assert checks["update_rel_err"]["value"] == pytest.approx(1.0)
