"""TF1 ``.meta`` checkpoints in the port (models/tf1_import.py and
``PixelClassifier.load``) against the JAX package: a real TF1 checkpoint
written as tests/test_tf1_import.py writes it, the same arrays, the same
logits, a wrong plan refused, and without tensorflow an ImportError that
names the conversion route."""
import sys

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from page_segmentation_tpu_torch.inference.classifier import PixelClassifier  # noqa: E402
from page_segmentation_tpu_torch.models import tf1_import  # noqa: E402
from page_segmentation_tpu_torch.models.registry import Architecture  # noqa: E402
from tests.test_tf1_import import _write_tf1_checkpoint  # noqa: E402


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    prefix = str(tmp_path_factory.mktemp("legacy") / "model")
    return prefix, _write_tf1_checkpoint(prefix)


@pytest.mark.parametrize("form", [".meta", "", ".h5"])
def test_identical_arrays_to_the_jax_import(checkpoint, form):
    from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
    from page_segmentation_tpu.models.tf1_import import load_tf1_checkpoint as jax_load

    prefix, written = checkpoint
    got = tf1_import.load_tf1_checkpoint(prefix + form, Architecture.FCN_SKIP, 3)
    want = jax_load(prefix + form, JaxArchitecture.FCN_SKIP, 3)
    assert set(got) == set(want) == set(written)
    for name, (kernel, bias) in written.items():
        assert got[name]["kernel"].dtype == np.float32
        np.testing.assert_array_equal(got[name]["kernel"], want[name]["kernel"])
        np.testing.assert_array_equal(got[name]["bias"], want[name]["bias"])
        np.testing.assert_array_equal(got[name]["kernel"], kernel)


def test_classifier_load_gives_the_jax_logits(checkpoint):
    from page_segmentation_tpu.data.dataset import SingleData as JaxSingleData
    from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
    from page_segmentation_tpu_torch.data.dataset import SingleData

    prefix, _ = checkpoint
    port = PixelClassifier(n_classes=3, model_path=prefix + ".h5", device="cpu")
    jax_cls = JaxClassifier(n_classes=3, model_path=prefix + ".h5")
    page = np.random.default_rng(0).integers(0, 256, (64, 48)).astype(np.uint8)
    with torch.inference_mode():
        logit, prob, pred = port.predict_single_data(SingleData(image=page, binary=np.ones_like(page)))
    want_logit, _, want_pred = jax_cls.predict_single_data(
        JaxSingleData(image=page, binary=np.ones_like(page)))
    assert logit.shape == (64, 48, 3) and prob.shape[-1] == 3 and pred.shape == (64, 48)
    np.testing.assert_allclose(logit, want_logit, rtol=0, atol=1e-5 * np.abs(want_logit).max())
    assert (pred == want_pred).mean() >= 0.999


def test_a_wrong_plan_is_refused(tmp_path):
    tf1 = tf.compat.v1
    prefix = str(tmp_path / "other" / "model")
    graph = tf1.Graph()
    with graph.as_default():
        tf1.get_variable("a/kernel", shape=(3, 3, 1, 8))
        tf1.get_variable("a/bias", shape=(8,))
        saver = tf1.train.Saver()
        with tf1.Session(graph=graph) as sess:
            sess.run(tf1.global_variables_initializer())
            saver.save(sess, prefix)
    with pytest.raises(ValueError, match="conv layers|kernel is"):
        tf1_import.load_tf1_checkpoint(prefix + ".meta", Architecture.FCN_SKIP, 3)
    with pytest.raises(ValueError, match="conv layers|kernel is"):
        PixelClassifier(3, model_path=prefix + ".h5", device="cpu")
    with pytest.raises(FileNotFoundError):
        tf1_import.load_tf1_checkpoint(str(tmp_path / "none.meta"), Architecture.FCN_SKIP, 3)


def test_without_tensorflow_loading_names_the_conversion_route(checkpoint, monkeypatch, tmp_path):
    """The card's machine has no tensorflow: the .meta route raises an
    ImportError naming the route, and the converted checkpoint directory
    loads there."""
    from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    prefix, _ = checkpoint
    params = tf1_import.load_tf1_checkpoint(prefix + ".meta", Architecture.FCN_SKIP, 3)
    save_checkpoint(str(tmp_path / "converted"), {"params": params},
                    {"architecture": "fcn_skip", "n_classes": 3})
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for load in (lambda: PixelClassifier(3, model_path=prefix + ".h5", device="cpu"),
                 lambda: tf1_import.load_tf1_checkpoint(prefix, Architecture.FCN_SKIP, 3)):
        with pytest.raises(ImportError, match="tensorflow") as err:
            load()
        assert "load_tf1_checkpoint" in str(err.value) and "save_checkpoint" in str(err.value)
    converted = PixelClassifier(3, model_path=str(tmp_path / "converted"), device="cpu")
    for name, entry in params.items():
        np.testing.assert_array_equal(converted.params[name]["kernel"], entry["kernel"])
