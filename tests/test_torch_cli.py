"""The port's command line (``cli/main.py``) against the JAX package's, on the
golden corpus and on the CPU.

One checkpoint serves both: the JAX package's ``save_checkpoint`` writes an
FCNSkip (3 classes) init, and both CLIs ``--load`` it.  Tolerances: the
labels decoded from the written color PNGs agree with the JAX CLI's on
>= 99.99 % of pixels in float32 (the convolutions are summed in another
order), and every written PNG of the trio decodes to the JAX CLI's pixels
wherever the labels agree."""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from page_segmentation_tpu.cli.main import main as jax_main
from page_segmentation_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from page_segmentation_tpu_torch.cli.main import main
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.core.image_io import imread, imsave
from page_segmentation_tpu_torch.models.bridge import init_params_numpy

CORPUS = Path(__file__).resolve().parent / "golden_corpus"
PALETTE = DEFAULT_IMAGE_MAP.palette
ROUTES = {
    "pipeline": ["--pipeline", "--post_process", "cc_majority", "--batch_size", "4"],
    "fast": ["--fast", "--batch_size", "4"],
    "per_page": [],
}


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    tree = init_params_numpy(3, seed=0)
    rng = np.random.default_rng(1)
    for leaves in tree.values():  # nonzero biases exercise the bias path
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    path = tmp_path_factory.mktemp("model") / "fcn_skip"
    jax_save_checkpoint(str(path), {"params": tree}, {"architecture": "fcn_skip", "n_classes": 3})
    return str(path)


def _predict_args(checkpoint, out, images=CORPUS / "images", binary=CORPUS / "binary"):
    return ["--load", checkpoint, "--output", str(out), "--images", str(images),
            "--binary", str(binary), "--char_height", "14", "--dtype", "float32"]


def _labels(color):
    return (color[..., None, :] == PALETTE).all(-1).argmax(-1)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_predict_writes_the_jax_clis_trio(checkpoint, tmp_path, route):
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    assert main(["predict", "--device", "cpu"] + _predict_args(checkpoint, port_out) + ROUTES[route]) == 0
    assert jax_main(["predict"] + _predict_args(checkpoint, jax_out) + ROUTES[route]) == 0
    names = sorted(os.listdir(CORPUS / "images"))
    agree = total = 0
    for sub in ("color", "overlay", "inverted"):
        assert sorted(os.listdir(port_out / sub)) == sorted(os.listdir(jax_out / sub)) == names
    for name in names:
        got = [imread(port_out / sub / name) for sub in ("color", "overlay", "inverted")]
        want = [imread(jax_out / sub / name) for sub in ("color", "overlay", "inverted")]
        same = _labels(got[0]) == _labels(want[0])
        agree, total = agree + int(same.sum()), total + same.size
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_array_equal(g[same], w[same])
    assert agree / total >= 0.9999, f"{route}: label agreement {agree / total:.6f}"


def _tiny_corpus(root):
    for sub in ("images", "binary"):
        (root / sub).mkdir(parents=True)
    for i in range(2):
        page = np.full((64, 48), 235, np.uint8)
        page[16:40, 8 + 4 * i : 30 + 4 * i] = 30
        imsave(root / "images" / f"p{i}.png", page)
        imsave(root / "binary" / f"p{i}.png", np.where(page >= 128, 255, 0).astype(np.uint8))
    return root


def test_bare_invocation_is_predict(checkpoint, tmp_path, capsys):
    corpus = _tiny_corpus(tmp_path / "corpus")
    out = tmp_path / "out"
    assert main(["--device", "cpu"] + _predict_args(checkpoint, out, corpus / "images",
                                                    corpus / "binary")) == 0
    assert f"Predicted 2 pages -> {out}" in capsys.readouterr().out
    assert sorted(os.listdir(out / "color")) == ["p0.png", "p1.png"]


def test_user_errors_return_2_with_one_line(checkpoint, tmp_path, capsys):
    assert main(["predict", "--device", "cpu", "--load", checkpoint, "--output", str(tmp_path / "o"),
                 "--images", "/nope/imgs"]) == 2
    err = capsys.readouterr().err
    assert err == "error: no such file or directory: /nope/imgs\n"
    corpus = _tiny_corpus(tmp_path / "corpus")
    assert main(["predict", "--device", "cpu", "--load", str(tmp_path / "missing"),
                 "--output", str(tmp_path / "o"), "--images", str(corpus / "images"),
                 "--char_height", "14"]) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: no such file or directory") and err.count("\n") == 1
    with pytest.raises(SystemExit, match="auto_norm"):
        main(["predict", "--device", "cpu", "--load", checkpoint, "--output", str(tmp_path / "o"),
              "--images", str(corpus / "images")])


@pytest.mark.parametrize("argv, item", [
    (["train", "--output", "o", "--checkpoint_backend", "orbax"], "item 11"),
    (["train", "--output", "o", "--auto_resume"], "item 11"),
    (["export", "--load", "m", "--output", "m.pt2"], "item 13"),
    (["predict", "--int8"], "item 13"),
    (["predict", "--n_devices", "2"], "item 12"),
    (["predict", "--band_rows", "64"], "item 12"),
])
def test_unported_subcommands_and_options_name_their_item(checkpoint, tmp_path, capsys, argv, item):
    if argv[0] == "predict":
        corpus = _tiny_corpus(tmp_path / "corpus")
        argv = argv[:1] + ["--device", "cpu"] + _predict_args(
            checkpoint, tmp_path / "o", corpus / "images", corpus / "binary") + argv[1:]
    assert main(argv) == 2
    err = capsys.readouterr().err
    assert err.startswith("error: ") and item in err and err.count("\n") == 1


def test_norm_dir_sets_the_line_height(checkpoint, tmp_path):
    corpus = _tiny_corpus(tmp_path / "corpus")
    norm = tmp_path / "norm"
    norm.mkdir()
    (norm / "p0.json").write_text(json.dumps({"char_height": 14}))
    (norm / "p1.json").write_text(json.dumps({"char_height": 12}))
    base = ["predict", "--device", "cpu", "--load", checkpoint, "--images", str(corpus / "images"),
            "--binary", str(corpus / "binary"), "--pipeline"]
    assert main(base + ["--output", str(tmp_path / "norm_out"), "--norm", str(norm)]) == 0
    shapes = {n: imread(tmp_path / "norm_out" / "color" / n).shape for n in ("p0.png", "p1.png")}
    assert shapes == {"p0.png": (27, 21, 3), "p1.png": (32, 24, 3)}


def test_default_device_is_the_card(checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    corpus = _tiny_corpus(tmp_path / "corpus")
    for extra in ([], ["--pipeline"]):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["predict"] + _predict_args(checkpoint, tmp_path / "o", corpus / "images",
                                             corpus / "binary") + extra)
