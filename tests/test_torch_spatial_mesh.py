"""The port's row bands across a device mesh (``parallel/spatial.py``
``spatial_forward``, ``spatial_forward_batch``, ``spatial_predict`` and
``Predictor(n_devices=...)``) against the JAX package's ``shard_map``
programs on the suite's virtual CPU devices, on the CPU.

The port's mesh holds the CPU as 2 or 4 devices.  Logits agree with the
JAX package's within the banded path's 5e-4 and with equal argmax, and
with the port's own unsplit forward the same way: fcn_skip and mobile_net
at narrow widths and an unaligned height (the pages x bands forms are in
``test_torch_spatial_mesh_batch.py``); the margin error reads as the JAX
one.  The
Predictor routes a page above the threshold through the mesh, with labels
equal to the JAX Predictor's, and never splits EfficientNet."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from page_segmentation_tpu.data.dataset import SingleData as JaxData
from page_segmentation_tpu.inference.predictor import Predictor as JaxPredictor
from page_segmentation_tpu.inference.predictor import PredictSettings as JaxSettings
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.parallel import spatial as jax_spatial
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu_torch.data.dataset import SingleData
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.parallel import spatial
from page_segmentation_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name):
    """The port's module with seeded weights and the JAX module with the
    same variables."""
    module = Architecture(name).model(3)
    variables = init_variables_numpy(module, 0)
    module.load_state_dict(params_from_jax(variables))
    chans = 3 if Architecture(name).preprocess()[1] else 1
    return JaxArchitecture(name).model(3), variables, module, chans


def _whole(module, image):
    with torch.no_grad():
        return module(torch.from_numpy(np.ascontiguousarray(image[None]))).numpy()[0]


def _close(got, *refs):
    for ref in refs:
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=5e-4)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("name, n_dev, h", [("fcn_skip", 2, 512), ("fcn_skip", 4, 768),
                                            ("mobile_net", 2, 512)])
def test_spatial_forward_matches_jax_and_the_unsplit_forward(name, n_dev, h):
    jax_module, variables, module, chans = _pair(name)
    image = np.random.RandomState(3).rand(h, 40, chans).astype(np.float32)
    kw = dict(margin=spatial.DEFAULT_MARGINS[name], stride_factor=Architecture(name).stride_factor)
    got = spatial.spatial_forward(module, image, make_mesh(n_dev, devices="cpu"), **kw)
    want = jax_spatial.spatial_forward(jax_module, variables, image, jax_make_mesh(n_dev), **kw)
    padded_w = -(-40 // kw["stride_factor"]) * kw["stride_factor"]
    canvas = np.zeros((h, padded_w, chans), np.float32)
    canvas[:, :40] = image
    _close(got, want, _whole(module, canvas)[:, :40])


def test_unaligned_height_pads_and_crops_back():
    jax_module, variables, module, _ = _pair("fcn_skip")
    image = np.random.RandomState(1).rand(1000, 48, 1).astype(np.float32)  # not a multiple of 32
    got = spatial.spatial_forward(module, image, make_mesh(4, devices="cpu"), margin=96)
    want = jax_spatial.spatial_forward(jax_module, variables, image, jax_make_mesh(4), margin=96)
    canvas = np.zeros((1024, 48, 1), np.float32)
    canvas[:1000] = image
    _close(got, want, _whole(module, canvas)[:1000])


@pytest.mark.parametrize("batch", [False, True])
def test_margin_error_reads_as_jax(batch):
    jax_module, variables, module, _ = _pair("fcn_skip")
    if batch:
        pages = np.zeros((2, 256, 32, 1), np.float32)
        mesh = make_mesh(4, shape=(1, 4), axis_names=("data", "space"), devices="cpu")
        jax_mesh = jax_make_mesh(4, shape=(1, 4), axis_names=("data", "space"))
        with pytest.raises(ValueError) as got:
            spatial.spatial_forward_batch(module, pages, mesh, margin=96)
        with pytest.raises(ValueError) as want:
            jax_spatial.spatial_forward_batch(jax_module, variables, pages, jax_mesh, margin=96)
    else:
        image = np.zeros((256, 32, 1), np.float32)  # 64-row bands < 2 x 96
        with pytest.raises(ValueError) as got:
            spatial.spatial_forward(module, image, make_mesh(4, devices="cpu"), margin=96)
        with pytest.raises(ValueError) as want:
            jax_spatial.spatial_forward(jax_module, variables, image, jax_make_mesh(4), margin=96)
    assert str(got.value) == str(want.value) and "halo margin" in str(got.value)


def test_spatial_forward_on_one_device_is_the_plain_forward():
    _, _, module, _ = _pair("fcn_skip")
    image = np.random.RandomState(9).rand(256, 32, 1).astype(np.float32)
    got = spatial.spatial_forward(module, image, make_mesh(1, devices="cpu"), margin=96)
    np.testing.assert_array_equal(got, _whole(module, image))


def _nets():
    """The port's classifier with seeded weights, and the JAX predict paths'
    view of a classifier (module, variables, preprocess) with the same ones."""
    net = PixelClassifier(3, device="cpu")
    arch = JaxArchitecture.FCN_SKIP
    preprocess, rgb = arch.preprocess()
    jax_net = SimpleNamespace(module=arch.model(3), variables=net.variables, architecture=arch,
                              preprocess=preprocess, rgb=rgb)
    return jax_net, net


def test_spatial_predict_matches_jax_and_the_single_page():
    jax_net, net = _nets()
    image = (np.random.RandomState(2).rand(768, 64) * 255).astype(np.uint8)
    got = spatial.spatial_predict(net, image, make_mesh(4, devices="cpu"))
    want = jax_spatial.spatial_predict(jax_net, image, jax_make_mesh(4))
    _, _, single = net.predict_single_data(SingleData(image=image))
    assert got.shape == (768, 64)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_predictor_n_devices_dispatch_matches_jax():
    jax_net, net = _nets()
    image = (np.random.RandomState(4).rand(1024, 56) * 255).astype(np.uint8)
    binary = np.ones(image.shape, np.uint8)
    settings = dict(n_classes=3, n_devices=4, spatial_threshold=50_000)
    predictor = Predictor(PredictSettings(**settings), network=net)
    jax_predictor = JaxPredictor(JaxSettings(**settings), network=jax_net)
    page = SingleData(image=image, binary=binary)
    assert predictor._spatial_mesh.devices.size == 4 and predictor._use_spatial(page)
    assert not predictor._use_spatial(SingleData(image=image[:100], binary=binary[:100]))
    got = predictor.predict_single(page)
    want = jax_predictor.predict_single(JaxData(image=image, binary=binary))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_allclose(got.probabilities, want.probabilities, atol=1e-4)
    plain = Predictor(PredictSettings(n_classes=3), network=net).predict_single(page)
    np.testing.assert_array_equal(got.labels, plain.labels)


def test_efficientnet_is_never_split():
    with torch.device("meta"):
        net = PixelClassifier.__new__(PixelClassifier)
    net.architecture = Architecture.EFFNETB0
    net.device = torch.device("cpu")
    predictor = Predictor(PredictSettings(n_classes=3, n_devices=2, spatial_threshold=1),
                          network=net)
    page = SingleData(image=np.zeros((4096, 64), np.uint8))
    assert "effb0" not in spatial.DEFAULT_MARGINS
    assert predictor._spatial_mesh is not None and not predictor._use_spatial(page)
    jax_predictor = JaxPredictor.__new__(JaxPredictor)
    jax_predictor.network = type("Net", (), {"architecture": JaxArchitecture.EFFNETB0})()
    jax_predictor.settings = JaxSettings(n_classes=3, n_devices=2, spatial_threshold=1)
    jax_predictor._spatial_mesh = jax_make_mesh(2)
    assert not jax_predictor._use_spatial(JaxData(image=np.zeros((4096, 64), np.uint8)))
