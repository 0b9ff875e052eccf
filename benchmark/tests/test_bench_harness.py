"""The harness finds every piece by name, keeps to the allowed names and
units, and loads neither JAX nor the JAX package."""
from __future__ import annotations

import ast
import json
import re
import shutil
import sys
from pathlib import Path

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_config_and_metric_has_its_files():
    s = spec()
    for w in s["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (BENCH / "drivers" / f"{cell.traffic['driver']}.py").exists()
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for c in s["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for m in s["end_to_end"] + s["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_names_units_and_shape_keep_to_the_rules():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in s[key]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in s["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["source"]) <= 200
    for m in s["end_to_end"] + s["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in s["per_layer"]:
        assert "\n" not in m["layer"] and m["moves"] in {e["name"] for e in s["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert 1 <= s["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_new_cell_config_and_metric_are_new_files_only(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries: nothing else changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    s = spec()
    config = json.loads((BENCH / "configs" / "fcnskip.json").read_text())
    (root / "benchmark" / "configs" / "fcnskip_wide.json").write_text(
        json.dumps({**config, "name": "fcnskip_wide"}))
    mix = json.loads((BENCH / "mixes" / "corpus.json").read_text())
    (root / "benchmark" / "mixes" / "corpus_small.json").write_text(
        json.dumps({**mix, "pool_pages": 48}))
    (root / "benchmark" / "workloads" / "fcnskip_wide.corpus_small.json").write_text(
        json.dumps({"decisive_margin": 0.05, "limits": {"decisive_mismatch": 1e-4}}))
    (root / "benchmark" / "metrics" / "pages_compared.fcnskip_wide.py").write_text(
        "def read(run):\n    return run.counts.get('compared_pages')\n")
    s["configs"].append({"name": "fcnskip_wide", "source": "https://example.org/fcnskip",
                         "file": "benchmark/configs/fcnskip_wide.json", "reduced": [], "why": "x"})
    s["workloads"].append({"name": "fcnskip_wide.corpus_small", "config": "fcnskip_wide",
                           "traffic": "corpus_small", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "pages_compared.fcnskip_wide", "unit": "pages",
                           "better": "higher", "source": "program_counter", "layer": "device",
                           "moves": "pages_per_s.fcnskip_wide",
                           "workloads": ["fcnskip_wide.corpus_small"]})
    s["end_to_end"].append({"name": "pages_per_s.fcnskip_wide", "unit": "pages/s", "better": "higher",
                            "bound": 0.1, "source": "host_clock",
                            "workloads": ["fcnskip_wide.corpus_small"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))

    cell = harness.load_cell("fcnskip_wide.corpus_small", root, root / "benchmark")
    assert cell.config["name"] == "fcnskip_wide" and cell.traffic["pool_pages"] == 48
    assert [m["name"] for m in cell.per_layer] == ["pages_compared.fcnskip_wide"]
    assert {m["name"] for m in cell.end_to_end} == {"pages_per_s.fcnskip_wide", "setup_s"}
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=True, device="cpu")
    run.counts["compared_pages"], run.counts["pages"], run.window_s = 7, 96, 2.0
    assert harness.read_metrics(run, cell.per_layer, root / "benchmark") == {
        "pages_compared.fcnskip_wide": {"value": 7.0, "unit": "pages"}}
    assert harness.read_metrics(run, cell.end_to_end, root / "benchmark")[
        "pages_per_s.fcnskip_wide"] == {"value": 48.0, "unit": "pages/s"}
    # a qualified metric with no file of its own reads with its kind's reader
    assert not (root / "benchmark" / "metrics" / "pages_per_s.fcnskip_wide.py").exists()
    # the old cells load as before from the new tree
    assert harness.load_cell("fcnskip.corpus", root, root / "benchmark").config["name"] == "fcnskip"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert not tops & set(harness.FORBIDDEN_MODULES), tops


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    tops = {name.split(".", 1)[0] for name in _imports(path)}
    assert "page_segmentation_tpu_torch" not in tops
    assert tops <= {"__future__", "contextlib", "math", "struct", "zlib", "typing", "numpy",
                    "torch", "scipy", "benchmark"}


def test_forbidden_modules_are_compared_by_whole_top_level_names():
    assert harness.forbidden_loaded(["page_segmentation_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert harness.forbidden_loaded(["jax.numpy", "page_segmentation_tpu.models", "flax"]) == [
        "flax", "jax", "page_segmentation_tpu"]
    assert harness.forbidden_loaded() == []


def test_a_run_without_a_card_fails_and_prints_no_result(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "fcnskip.corpus", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_the_result_line_ends_with_the_checks():
    cell = harness.load_cell("fcnskip.corpus")
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=False, device="cpu")
    run.check("decisive_mismatch", 1e-6)
    line = harness.result_line(run, {"pages_per_s": {"value": 1.0, "unit": "pages/s"}},
                               {"platform": "gpu"}, None)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["correct"] is True
    run.check("decisive_mismatch", 1.0)
    assert harness.result_line(run, {}, {}, None)["correct"] is False


def test_no_check_means_not_correct():
    cell = harness.load_cell("fcnskip.corpus")
    run = harness.Run(cell=cell, seed=1, seconds=1.0, trace=False, device="cpu")
    assert harness.result_line(run, {}, {}, None)["correct"] is False


def test_the_harness_never_imports_jax():
    assert not {m.split(".", 1)[0] for m in sys.modules} & {"jax", "jaxlib", "flax"}
