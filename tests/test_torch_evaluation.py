"""The port's evaluation modules and its ``evaluate`` and
``compute-image-normalizations`` commands against the JAX package's, on the
CPU.

Tolerances: the metrics are exactly equal on the same seeded masks; the
char heights equal the golden corpus's frozen values on every page; the
``evaluate`` report equals the JAX CLI's to 1e-12."""
import json
import os
from pathlib import Path

import numpy as np
import pytest

from page_segmentation_tpu.cli.main import main as jax_main
from page_segmentation_tpu.evaluation import image_ops as jax_image_ops
from page_segmentation_tpu.evaluation import metrics as jax_metrics
from page_segmentation_tpu_torch.cli.main import main, main_compute_normalizations
from page_segmentation_tpu_torch.core.colors import ColorMap
from page_segmentation_tpu_torch.core.image_io import imsave
from page_segmentation_tpu_torch.evaluation import image_ops, metrics

CORPUS = Path(__file__).resolve().parent / "golden_corpus"


def _masks(seed, shape=(61, 47), n_classes=3):
    """(pred, mask, binary): a mask of class blocks, a prediction that
    differs on a share of pixels (some out of range), and a binary."""
    rng = np.random.default_rng(seed)
    mask = np.repeat(np.repeat(rng.integers(0, n_classes, (8, 6)), 8, 0), 8, 1)[: shape[0], : shape[1]]
    pred = np.where(rng.random(shape) < 0.3, rng.integers(-1, n_classes + 1, shape), mask)
    return pred, mask, (rng.random(shape) < 0.4).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_image_ops_match_jax(seed):
    pred, mask, binary = _masks(seed)
    assert image_ops.fgpa(pred, mask, binary) == jax_image_ops.fgpa(pred, mask, binary)
    assert image_ops.fgpa(pred, mask, binary * 0) == jax_image_ops.fgpa(pred, mask, binary * 0) == 0
    got = image_ops.fgoverlap_per_class(pred, mask, binary, 3)
    want = jax_image_ops.fgoverlap_per_class(pred, mask, binary, 3)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))  # nan where nan
    assert got[1:] == want[1:]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_match_jax(seed):
    pred, mask, binary = _masks(seed)
    for label in range(-1, 4):
        tp_fp_fn = metrics.count_matches(mask, pred, label)
        assert tp_fp_fn == jax_metrics.count_matches(mask, pred, label)
        assert metrics.f1_measures(*tp_fp_fn) == jax_metrics.f1_measures(*tp_fp_fn)
    assert metrics.total_accuracy(mask, pred) == jax_metrics.total_accuracy(mask, pred)
    assert metrics.f1(0.25, 0.5) == jax_metrics.f1(0.25, 0.5)

    def per_component(module, matcher, only=None):
        evaluation = module.ConnectedComponentEval(mask, pred, binary)
        if only is not None:
            evaluation.only_label(*only)
        return [np.asarray(r).tolist() for r in evaluation.run_per_component(matcher)]

    for label, args, only in ((1, (0.5, 0.1), None), (0, (0.7, 0.3, 0.6), (0, 0.5)),
                              (2, (0.9, 0.5), (2, 0.2))):
        got = per_component(metrics, metrics.cc_matching(label, *args), only)
        assert got and got == per_component(jax_metrics, jax_metrics.cc_matching(label, *args), only)
    assert (per_component(metrics, metrics.cc_equal(0.8))
            == per_component(jax_metrics, jax_metrics.cc_equal(0.8)))


def test_char_height_of_arrays_matches_jax():
    rng = np.random.default_rng(3)
    for inverse in (False, True):
        img = np.full((200, 180), 250 if not inverse else 5, np.uint8)
        for row in range(10, 170, 30):
            for col in range(5, 160, 17):
                h = int(rng.integers(8, 30))
                img[row : row + h, col : col + 11] = 5 if not inverse else 250
        got = image_ops.compute_char_height_arr(img, inverse)
        assert got is not None and got == jax_image_ops.compute_char_height_arr(img, inverse)
    assert image_ops.compute_char_height_arr(np.full((40, 40), 255, np.uint8), False) is None


def test_compute_normalizations_cli_reproduces_the_frozen_char_heights(tmp_path):
    with open(CORPUS / "frozen.json") as f:
        frozen = json.load(f)["char_height"]
    assert main(["compute-image-normalizations", "--input_dir", str(CORPUS / "images"),
                 "--output_dir", str(tmp_path / "norm")]) == 0
    assert main_compute_normalizations(["--input-dir", str(CORPUS / "images"),
                                        "--output-dir", str(tmp_path / "alias"),
                                        "--average_all"]) == 0
    average = int(np.round(np.mean(list(frozen.values()))))
    assert len(frozen) == 11
    for page, expected in frozen.items():
        assert json.loads((tmp_path / "norm" / f"{page}.json").read_text())["char_height"] == expected
        assert json.loads((tmp_path / "alias" / f"{page}.json").read_text())["char_height"] == average


def test_evaluate_cli_prints_the_jax_clis_numbers(tmp_path, capsys):
    cmap = {"(255, 255, 255)": [0, "background"], "(255, 0, 0)": [1, "text"],
            "(0, 255, 0)": [2, "image"]}
    (tmp_path / "map.json").write_text(json.dumps(cmap))
    color_map = ColorMap.load(tmp_path / "map.json")
    for sub in ("masks", "preds", "binary"):
        (tmp_path / sub).mkdir()
    for i in range(4):
        pred, mask, binary = _masks(10 + i, shape=(50 + 3 * i, 40))
        pred = np.clip(pred, 0, 2)
        imsave(tmp_path / "masks" / f"p{i}.png", color_map.to_rgb_array(mask))
        if i != 3:  # one mask without its prediction: skipped with a warning
            imsave(tmp_path / "preds" / f"p{i}.png", color_map.to_rgb_array(pred))
        imsave(tmp_path / "binary" / f"p{i}.png", np.where(binary == 1, 0, 255).astype(np.uint8))
    args = ["evaluate", "--masks", str(tmp_path / "masks"), "--predictions", str(tmp_path / "preds"),
            "--binary", str(tmp_path / "binary"), "--color_map", str(tmp_path / "map.json")]
    capsys.readouterr()
    reports = []
    for run in (main, jax_main):
        assert run(args) == 0
        reports.append(json.loads(capsys.readouterr().out))
    got, want = reports
    assert set(got) == set(want) == {"accuracy", "label_0", "label_1", "label_2", "fgpa"}
    assert abs(got["accuracy"] - want["accuracy"]) <= 1e-12 and abs(got["fgpa"] - want["fgpa"]) <= 1e-12
    for label in ("label_0", "label_1", "label_2"):
        for key in ("precision", "recall", "f1"):
            assert abs(got[label][key] - want[label][key]) <= 1e-12
    assert 0 < got["accuracy"] < 1


def test_char_height_of_a_missing_file_is_a_user_error(tmp_path, capsys):
    (tmp_path / "in").mkdir()
    assert main(["compute-image-normalizations", "--input_dir", str(tmp_path / "nope"),
                 "--output_dir", str(tmp_path / "out")]) == 2
    assert capsys.readouterr().err.strip().count("\n") == 0
    with pytest.raises(FileNotFoundError):
        image_ops.compute_char_height(os.path.join(tmp_path, "missing.png"), False)
