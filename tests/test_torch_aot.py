"""The port's ``torch.export`` artifact (``inference/aot.py``, the
``export`` CLI) against the port's own forward and the JAX package's
``jax.export`` artifact, on the CPU.

The exported program runs the same torch ops as
``PixelClassifier.masks_device``, so its class map equals that path's
exactly; against the JAX artifact on the same weights the logits agree
within 1e-4 and the argmax on decisive pixels (top-2 margin >= 5 % of the
largest |logit|).  Pages that are not stride multiples are padded and
cropped; static mode picks the smallest exported shape that fits."""
import json
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.inference import aot as jax_aot
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu_torch.cli.main import main
from page_segmentation_tpu_torch.inference.aot import FORMAT, AotClassifier, export_classifier
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def classifier():
    return PixelClassifier(3, device="cpu", seed=3)


@pytest.fixture(scope="module")
def artifacts(classifier, tmp_path_factory):
    root = tmp_path_factory.mktemp("aot")
    paths = {"symbolic": str(root / "symbolic.zip"), "static": str(root / "static.zip"),
             "logits": str(root / "logits.zip")}
    export_classifier(classifier, paths["symbolic"], platforms=["cpu"])
    export_classifier(classifier, paths["static"], platforms=["cpu"], shapes=[(96, 80), (64, 48)])
    export_classifier(classifier, paths["logits"], output="logits", platforms=["cpu"])
    return paths


def _reference_pred(classifier, images):
    """The port's batched dispatch, without a vote."""
    return classifier.masks_device(torch.from_numpy(images), None, pack=False).numpy()


def test_symbolic_program_equals_the_classifier(classifier, artifacts):
    aot = AotClassifier(artifacts["symbolic"], device="cpu")
    assert aot.manifest["symbolic"] and aot.manifest["platforms"] == ["cpu"]
    rng = np.random.RandomState(0)
    for shape in [(1, 64, 48), (2, 96, 80), (3, 32, 120)]:
        images = rng.randint(0, 256, shape).astype(np.uint8)
        np.testing.assert_array_equal(aot.predict(images), _reference_pred(classifier, images))


def test_pad_and_crop_non_multiple_shapes(classifier, artifacts):
    aot = AotClassifier(artifacts["symbolic"], device="cpu")
    image = np.random.RandomState(1).randint(0, 256, (37, 53)).astype(np.uint8)
    out = aot(image)
    assert out.shape == (37, 53) and out.dtype == np.uint8
    padded = np.pad(image, ((0, 3), (0, 3)))
    np.testing.assert_array_equal(out, _reference_pred(classifier, padded[None])[0, :37, :53])


def test_static_mode_picks_the_smallest_fitting_shape(classifier, artifacts):
    aot = AotClassifier(artifacts["static"], device="cpu")
    assert not aot.manifest["symbolic"] and aot.manifest["shapes"] == [[96, 80], [64, 48]]
    assert aot._program_for(40, 40)[1:] == (64, 48)
    assert aot._program_for(72, 48)[1:] == (96, 80)
    with pytest.raises(ValueError, match="no exported shape fits"):
        aot._program_for(128, 48)
    images = np.random.RandomState(2).randint(0, 256, (2, 50, 41)).astype(np.uint8)
    padded = np.zeros((2, 64, 48), np.uint8)
    padded[:, :50, :41] = images
    np.testing.assert_array_equal(aot.predict(images),
                                  _reference_pred(classifier, padded)[:, :50, :41])
    with pytest.raises(ValueError, match="stride factor"):
        export_classifier(classifier, "unused.zip", platforms=["cpu"], shapes=[(60, 48)])


def test_logits_match_the_jax_artifact(classifier, artifacts, tmp_path):
    jax_net = JaxClassifier(n_classes=3)
    jax_net.variables = jax.tree_util.tree_map(np.asarray, {"params": classifier.params})
    jax_path = str(tmp_path / "jax.psx")
    jax_aot.export_classifier(jax_net, jax_path, output="logits", platforms=("cpu",))
    images = np.random.RandomState(3).randint(0, 256, (2, 61, 45)).astype(np.uint8)
    got = AotClassifier(artifacts["logits"], device="cpu").predict(images)
    want = jax_aot.AotClassifier(jax_path).predict(images)
    assert got.shape == want.shape == (2, 61, 45, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    top2 = np.sort(want, -1)[..., -2:]
    decisive = top2[..., 1] - top2[..., 0] >= 0.05 * np.abs(want).max()
    assert decisive.mean() > 0.3
    np.testing.assert_array_equal(got.argmax(-1)[decisive], want.argmax(-1)[decisive])


def test_rgb_family_exports(tmp_path):
    net = PixelClassifier(3, architecture=Architecture.MOBILE_NET, device="cpu", seed=1)
    path = str(tmp_path / "mobile.zip")
    manifest = export_classifier(net, path, platforms=["cpu"], shapes=[(64, 64)])
    assert manifest["architecture"] == "mobile_net" and manifest["stride_factor"] == 32
    images = np.random.RandomState(4).randint(0, 256, (2, 64, 64)).astype(np.uint8)
    np.testing.assert_array_equal(AotClassifier(path, device="cpu").predict(images),
                                  _reference_pred(net, images))


def test_the_zip_holds_the_manifest_and_the_programs(artifacts, tmp_path):
    for path, programs in ((artifacts["symbolic"], ["program.cpu.pt2"]),
                           (artifacts["static"], ["program_96x80.cpu.pt2",
                                                  "program_64x48.cpu.pt2"])):
        with zipfile.ZipFile(path) as zf:
            assert sorted(zf.namelist()) == sorted(["manifest.json"] + programs)
            manifest = json.loads(zf.read("manifest.json"))
        assert manifest["format"] == FORMAT and manifest["torch_version"] == torch.__version__
        assert set(manifest) == {"format", "version", "architecture", "n_classes", "output",
                                 "platforms", "stride_factor", "symbolic", "shapes",
                                 "torch_version"}
    bogus = str(tmp_path / "bogus.zip")
    with zipfile.ZipFile(bogus, "w") as zf:
        zf.writestr("manifest.json", json.dumps({"format": "something-else"}))
    with pytest.raises(ValueError, match="not a"):
        AotClassifier(bogus, device="cpu")
    with zipfile.ZipFile(bogus, "w") as zf:
        zf.writestr("weights.bin", b"")
    with pytest.raises(ValueError, match="not a"):
        AotClassifier(bogus, device="cpu")


def test_cli_export_from_a_checkpoint(classifier, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, classifier.params, {"architecture": "fcn_skip", "n_classes": 3})
    out = str(tmp_path / "model.zip")
    assert main(["export", "--load", ckpt, "--output", out, "--platforms", "cpu"]) == 0
    images = np.random.RandomState(5).randint(0, 256, (2, 48, 40)).astype(np.uint8)
    loaded = PixelClassifier(3, model_path=ckpt, device="cpu")
    np.testing.assert_array_equal(AotClassifier(out, device="cpu").predict(images),
                                  _reference_pred(loaded, images))


def test_a_missing_device_raises(classifier, artifacts, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        AotClassifier(artifacts["symbolic"])
    with pytest.raises(RuntimeError, match="cuda"):
        export_classifier(classifier, str(tmp_path / "unused.zip"), platforms=["cuda"])
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, classifier.params, {"architecture": "fcn_skip", "n_classes": 3})
    with pytest.raises(RuntimeError, match="cuda"):  # the default platforms are cuda and cpu
        main(["export", "--load", ckpt, "--output", str(tmp_path / "unused.zip")])
    assert not os.path.exists(tmp_path / "unused.zip")
