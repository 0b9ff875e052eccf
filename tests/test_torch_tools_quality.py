"""The port's training-quality tool
(``page_segmentation_tpu_torch/tools/train_quality.py``) against the JAX
package's (``tools/train_quality.py``) on the golden corpus, on the CPU: the
same split search and staging, the same ``evaluate`` report from the same
prediction PNGs, held-out metrics within 1e-3 of the JAX chain's from one
checkpoint, and a whole run of the tool for 2 epochs writing a record with
the keys of the JAX tool's record.  Torch runs on one thread here, as in
the other training tests (several test processes share the cores)."""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from page_segmentation_tpu.cli.main import main as jax_cli  # noqa: E402
from page_segmentation_tpu_torch.cli.main import main as cli  # noqa: E402
from page_segmentation_tpu_torch.core.image_io import imsave  # noqa: E402
from page_segmentation_tpu_torch.tools import train_quality  # noqa: E402
from tools import train_quality as jax_train_quality  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """Both tools' staging of the corpus, from seed 7."""
    port, ref = tmp_path_factory.mktemp("port"), tmp_path_factory.mktemp("jax")
    return (str(port), train_quality.stage_golden_split(str(port), cli, 7)), \
        (str(ref), jax_train_quality.stage_golden_split(str(ref), jax_cli, 7))


def test_split_search_picks_the_jax_tools_split(staged):
    (port_root, port), (ref_root, ref) = staged
    assert (port["split_seed"], port["test_pages"], port["n_pages"]) == \
        (ref["split_seed"], ref["test_pages"], ref["n_pages"]) == (10, ["page10", "page4"], 11)
    with open(port["dataset_json"]) as f, open(ref["dataset_json"]) as g:
        assert f.read().replace(port_root, "<root>") == g.read().replace(ref_root, "<root>")
    for name in sorted(os.listdir(os.path.join(ref["ds"], "masks"))):
        assert Path(port["ds"], "masks", name).read_bytes() == \
            Path(ref["ds"], "masks", name).read_bytes(), name
    assert Path(port["image_map"]).read_bytes() == Path(ref["image_map"]).read_bytes()
    assert port["cmap"].mapping == ref["cmap"].mapping


def test_evaluate_gives_the_jax_report_from_the_same_predictions(staged, tmp_path):
    """Ground truth with a fifth of the pixels relabelled at random stands
    in for predictions; both tools' ``run_evaluate`` read them."""
    (port_root, port), (ref_root, ref) = staged
    held = train_quality.stage_held_out(port_root, port["ds"], port["test_pages"], port["cmap"])
    ref_held = jax_train_quality.stage_held_out(ref_root, ref["ds"], ref["test_pages"], ref["cmap"])
    pred = tmp_path / "color"
    pred.mkdir()
    rng = np.random.default_rng(3)
    for page in port["test_pages"]:
        labels = port["cmap"].imread_labels(os.path.join(held, "gt_masks", f"{page}.png"))
        flip = rng.random(labels.shape) < 0.2
        labels[flip] = rng.integers(0, 3, int(flip.sum()))
        imsave(str(pred / f"{page}.png"), port["cmap"].to_rgb_array(labels))
    got = train_quality.run_evaluate(cli, held, str(pred), port["image_map"], port["test_pages"])
    want = jax_train_quality.run_evaluate(jax_cli, ref_held, str(pred), ref["image_map"],
                                          ref["test_pages"])
    assert got == want
    os.remove(pred / f"{port['test_pages'][0]}.png")
    with pytest.raises(RuntimeError, match="not the held-out"):
        train_quality.run_evaluate(cli, held, str(pred), port["image_map"], port["test_pages"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The port's workflow for 2 epochs on the CPU, its paths kept."""
    args = train_quality.build_parser().parse_args(
        ["--n-epoch", "2", "--monitor", "val_accuracy", "--device", "cpu"])
    return train_quality.run_workflow(args, str(tmp_path_factory.mktemp("trained")))


def test_held_out_metrics_from_one_checkpoint_match_the_jax_chain(trained, tmp_path):
    paths = trained["paths"]
    jax_args = ["predict", "--load", paths["model"], "--output", str(tmp_path / "jax"), "--fast",
                "--images", os.path.join(paths["held"], "images"),
                "--binary", os.path.join(paths["held"], "binary"),
                "--norm", os.path.join(paths["held"], "norm"), "--color_map", paths["image_map"],
                "--target_line_height", "10", "--high_res_output"]
    assert jax_cli(jax_args) == 0
    want = jax_train_quality.run_evaluate(jax_cli, paths["held"], str(tmp_path / "jax" / "color"),
                                          paths["image_map"], trained["test_pages"])
    got = train_quality.run_evaluate(cli, paths["held"], os.path.join(paths["pred"], "color"),
                                     paths["image_map"], trained["test_pages"])
    assert got.keys() == want.keys()
    for key in ("fgpa", "accuracy"):
        assert abs(got[key] - want[key]) <= 1e-3, key
    for label in ("label_0", "label_1", "label_2"):
        for metric, value in want[label].items():
            assert abs(got[label][metric] - value) <= 1e-3, (label, metric)
    assert abs(trained["value"] - want["fgpa"]) <= 1e-3


def test_the_whole_tool_writes_a_record_with_the_jax_records_keys(tmp_path, capsys):
    record = tmp_path / "quality.json"
    assert train_quality.main(["--n-epoch", "2", "--monitor", "val_accuracy", "--device", "cpu",
                               "--record", str(record)]) == 0
    result = json.loads(record.read_text())
    assert result == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(REPO / "bench_runs" / "r5_train_quality.json") as f:
        assert result.keys() == json.load(f).keys()
    assert (result["split_seed"], result["test_pages"]) == (10, ["page10", "page4"])
    assert result["epochs_ran"] == result["n_epoch_requested"] == 2
    assert result["monitor"] == "val_accuracy" and result["augmented"] is True
    assert set(result["per_label"]) == {"label_0", "label_1", "label_2"}
