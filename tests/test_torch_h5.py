"""Keras ``.h5`` import and export in the port against the JAX package.

One file gives identical parameter arrays in both packages: the grayscale
families from files the JAX ``save_keras_h5`` wrote, the BatchNorm
families from reference-shaped Keras models (``tests/keras_oracles.py``,
built with ``weights=None``).  The port's export writes the same datasets
as the JAX exporter and reads back identically through the JAX importer.
``load_encoder_into`` takes a backbone ``.h5`` and a provisioned encoder
directory; without h5py the ``.h5`` routes raise an ``ImportError`` that
names the checkpoint route."""
import sys

import h5py
import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.models import h5_export as jax_export
from page_segmentation_tpu.models import h5_import as jax_import
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models import h5_export, h5_import
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
from page_segmentation_tpu_torch.models.registry import Architecture
from tests.torch_families import calibrated, page_input

tf = pytest.importorskip("tensorflow")

from tests.keras_oracles import HW, N_CLASSES, keras_eff_net, keras_mobile_net, keras_res_net  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _assert_same_trees(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [jax.tree_util.keystr(p) for p, _ in flat_got] == [jax.tree_util.keystr(p) for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert np.asarray(a).dtype == np.asarray(b).dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=jax.tree_util.keystr(path))


def _h5_datasets(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None)
        attrs = {k: list(v) for k, v in f["model_weights"].attrs.items()}
    return out, attrs


GRAY = ["fcn_skip", "fcn", "unet", "res_unet"]


@pytest.mark.parametrize("name", GRAY)
def test_gray_h5_from_jax_export_gives_identical_arrays(name, tmp_path):
    arch = Architecture(name)
    variables = init_variables_numpy(arch.model(3), seed=4)
    path = str(tmp_path / f"{name}.h5")
    jax_export.save_keras_h5(path, variables["params"], JaxArchitecture(name))
    got, detected = h5_import.load_keras_variables(path, Architecture.FCN_SKIP, 3)
    want, jax_detected = jax_import.load_keras_variables(path, JaxArchitecture.FCN_SKIP, 3)
    assert detected is arch and jax_detected.value == name
    _assert_same_trees(got, want)
    _assert_same_trees(got, variables)

    # the port's export writes the JAX exporter's file, and JAX reads it back
    mine = str(tmp_path / f"{name}_port.h5")
    h5_export.save_keras_variables(mine, variables, arch)
    (a, a_attrs), (b, b_attrs) = _h5_datasets(mine), _h5_datasets(path)
    assert a_attrs == b_attrs and a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])
    back, _ = jax_import.load_keras_variables(mine, JaxArchitecture(name), 3)
    _assert_same_trees(back, variables)


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("keras")
    files = {}
    for name, build in (("mobile_net", keras_mobile_net), ("image_res_net", keras_res_net),
                        ("effb0", keras_eff_net)):
        files[name] = str(root / f"{name}.h5")
        build().save(files[name])
    return files


@pytest.mark.parametrize("name", ["mobile_net", "image_res_net", "effb0"])
def test_bn_family_h5_gives_identical_arrays_and_exports_back(name, keras_files, tmp_path):
    path = keras_files[name]
    got, detected = h5_import.load_keras_variables(path, Architecture(name), N_CLASSES)
    want, jax_detected = jax_import.load_keras_variables(path, JaxArchitecture(name), N_CLASSES)
    assert detected is Architecture(name) and jax_detected.value == name
    _assert_same_trees(got, want)
    module = Architecture(name).model(N_CLASSES)
    module.load_state_dict(params_from_jax(got))  # every leaf has its module slot

    mine, theirs = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    h5_export.save_keras_variables(mine, got, Architecture(name))
    jax_export.save_keras_variables(theirs, want, JaxArchitecture(name))
    (a, a_attrs), (b, b_attrs) = _h5_datasets(mine), _h5_datasets(theirs)
    assert a_attrs == b_attrs and a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    back, _ = jax_import.load_keras_variables(mine, JaxArchitecture(name), N_CLASSES)
    _assert_same_trees(back, want)  # the import's identity BN folds back exactly


def test_classifier_loads_a_reference_h5_and_predicts_like_jax(keras_files):
    from page_segmentation_tpu.data.dataset import SingleData as JaxSingleData
    from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
    from page_segmentation_tpu_torch.data.dataset import SingleData

    port = PixelClassifier(N_CLASSES, model_path=keras_files["mobile_net"], device="cpu")
    jax_cls = JaxClassifier(N_CLASSES, model_path=keras_files["mobile_net"])
    assert port.architecture is Architecture.MOBILE_NET and port.rgb
    _assert_same_trees(port.variables, dict(jax_cls.variables))
    page = np.random.default_rng(0).integers(0, 256, (HW - 5, HW + 7)).astype(np.uint8)
    logit, _, pred = port.predict_single_data(SingleData(image=page))
    want_logit, _, want_pred = jax_cls.predict_single_data(JaxSingleData(image=page))
    assert logit.shape == (HW - 5, HW + 7, N_CLASSES)
    np.testing.assert_allclose(logit, want_logit, atol=1e-4 * np.abs(want_logit).max())
    assert (pred == want_pred).mean() >= 0.999


def test_effnet_variant_comes_from_the_weights(tmp_path):
    """The reference names every eff_net model 'effb0'; a B1 file imports
    as effb1 with the dead tail filled from the module's own shapes."""
    path = str(tmp_path / "b1.h5")
    keras_eff_net(tf.keras.applications.EfficientNetB1).save(path)
    got, detected = h5_import.load_keras_variables(path, Architecture.EFFNETB0, N_CLASSES)
    want, jax_detected = jax_import.load_keras_variables(path, JaxArchitecture.EFFNETB0, N_CLASSES)
    assert detected is Architecture.EFFNETB1 and jax_detected is JaxArchitecture.EFFNETB1
    _assert_same_trees(got, want)


@pytest.fixture(scope="module")
def backbone(tmp_path_factory):
    tf.keras.utils.set_random_seed(13)
    path = tmp_path_factory.mktemp("bb") / "mobilenetv2.h5"
    tf.keras.applications.MobileNetV2(weights=None, include_top=False,
                                      input_shape=(HW, HW, 3)).save(str(path))
    return str(path)


def test_load_encoder_into_from_h5_and_from_a_provisioned_directory(backbone, tmp_path, capsys):
    from tools.provision_pretrained import main as provision

    fresh = init_variables_numpy(Architecture.MOBILE_NET.model(N_CLASSES), seed=2)
    got = h5_import.load_encoder_into(fresh, Architecture.MOBILE_NET, backbone)
    want = jax_import.load_encoder_into(fresh, JaxArchitecture.MOBILE_NET, backbone)
    _assert_same_trees(got, want)
    assert not np.array_equal(got["params"]["encoder"]["stem"]["conv"]["kernel"],
                              fresh["params"]["encoder"]["stem"]["conv"]["kernel"])
    np.testing.assert_array_equal(got["params"]["up0"]["kernel"], fresh["params"]["up0"]["kernel"])

    out = tmp_path / "encoder"
    assert provision([backbone, "--out", str(out)]) == 0
    capsys.readouterr()
    _assert_same_trees(h5_import.load_encoder_into(fresh, Architecture.MOBILE_NET, str(out)), got)
    with pytest.raises(ValueError, match="backbone"):
        h5_import.load_encoder_into(fresh, Architecture.RES_NET, str(out))
    with pytest.raises(ValueError, match="pretrained encoders"):
        h5_import.load_encoder_into(fresh, Architecture.UNET, backbone)


def test_without_h5py_the_h5_routes_name_the_checkpoint_route(monkeypatch, tmp_path, keras_files):
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="save_checkpoint"):
        PixelClassifier(N_CLASSES, model_path=keras_files["mobile_net"], device="cpu")
    with pytest.raises(ImportError, match="h5py"):
        h5_export.save_keras_variables(str(tmp_path / "x.h5"), {"params": {}}, Architecture.FCN_SKIP)


def test_h5_converted_to_a_checkpoint_loads_without_h5py(keras_files, tmp_path, monkeypatch):
    """The card's route: convert where h5py exists, load the directory."""
    from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    variables, arch = h5_import.load_keras_variables(keras_files["effb0"], Architecture.EFFNETB0, N_CLASSES)
    save_checkpoint(str(tmp_path / "ckpt"), variables, {"architecture": arch.value, "n_classes": N_CLASSES})
    monkeypatch.setitem(sys.modules, "h5py", None)
    port = PixelClassifier(N_CLASSES, model_path=str(tmp_path / "ckpt"), device="cpu")
    assert port.architecture is Architecture.EFFNETB0
    _assert_same_trees(port.variables, variables)


def test_export_of_calibrated_weights_reads_back_through_jax(tmp_path):
    """Weights with non-trivial statistics (calibrated) round-trip the
    port's export through the JAX importer."""
    arch = Architecture.RES_NET
    _, variables = calibrated(arch, page_input(arch, n=1))
    path = str(tmp_path / "resnet.h5")
    h5_export.save_keras_variables(path, variables, arch)
    back, _ = jax_import.load_keras_variables(path, JaxArchitecture.RES_NET, 3)
    _assert_same_trees(back, variables)
