"""The port's row bands of tall pages (``parallel/spatial.py``,
``Predictor(band_rows=...)``) against the JAX package's, on the CPU.

The halo margins are the JAX table; the measured half receptive fields are
the JAX package's on the same weights.  ``banded_forward`` of the port
equals the JAX package's (weights carried with the bridge) within the JAX
test's 5e-4 and with equal argmax, on fcn_skip and mobile_net at 704x64 in
bands of 192 rows, whose last band is ragged; it equals the port's own
unsplit forward the same way.  A short page runs whole; the Predictor's
labels of a tall page equal the JAX Predictor's; EfficientNet is never
banded; spatial partitioning over several devices runs and takes
precedence over bands."""
import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP as JAX_MAP
from page_segmentation_tpu.data.dataset import SingleData as JaxData
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.inference.predictor import Predictor as JaxPredictor
from page_segmentation_tpu.inference.predictor import PredictSettings as JaxSettings
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.parallel import spatial as jax_spatial
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.data.dataset import SingleData
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.parallel import spatial


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name):
    """The port's module with seeded weights (flax's init law), and the JAX
    module with the same variables."""
    chans = 3 if Architecture(name).preprocess()[1] else 1
    module = Architecture(name).model(3)
    variables = init_variables_numpy(module, 0)
    module.load_state_dict(params_from_jax(variables))
    return JaxArchitecture(name).model(3), variables, module, chans


def test_margin_table_equals_jax():
    assert spatial.DEFAULT_MARGINS == jax_spatial.DEFAULT_MARGINS


@pytest.mark.parametrize("name", ["fcn_skip", "unet", "mobile_net"])
def test_measured_half_receptive_field_equals_jax(name):
    jax_module, variables, module, chans = _pair(name)
    # 512 rows hold every table margin on both sides of the probe
    half = spatial.measure_half_rf(module, height=512, channels=chans)
    assert half == jax_spatial.measure_half_rf(jax_module, variables, height=512, channels=chans)
    margin = spatial.DEFAULT_MARGINS[name]
    assert half <= margin and margin % Architecture(name).stride_factor == 0
    if name == "fcn_skip":  # 72 rounded up to 8; the table keeps 80
        assert spatial.derived_margin(Architecture(name), module) == 72


@pytest.mark.parametrize("name", ["fcn_skip", "mobile_net"])
def test_banded_forward_matches_jax_and_the_unsplit_forward(name):
    jax_module, variables, module, chans = _pair(name)
    image = np.random.RandomState(3).rand(704, 64, chans).astype(np.float32)
    kw = dict(band_rows=192, margin=spatial.DEFAULT_MARGINS[name],
              stride_factor=Architecture(name).stride_factor)
    got = spatial.banded_forward(module, image, **kw)
    want = jax_spatial.banded_forward(jax_module, variables, image, **kw)
    with torch.no_grad():
        whole = module(torch.from_numpy(image[None])).numpy()[0]
    assert got.shape == want.shape == whole.shape == (704, 64, 3)
    for ref in (want, whole):
        np.testing.assert_allclose(got, ref, atol=5e-4)
        np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))


def test_short_page_runs_whole():
    _, _, module, _ = _pair("fcn_skip")
    image = np.random.RandomState(0).rand(93, 45, 1).astype(np.float32)
    got = spatial.banded_forward(module, image, band_rows=512, margin=80)
    padded = np.zeros((96, 48, 1), np.float32)
    padded[:93, :45] = image
    with torch.no_grad():
        whole = module(torch.from_numpy(padded[None])).numpy()[0, :93, :45]
    np.testing.assert_array_equal(got, whole)


def test_predictor_band_rows_labels_equal_jax():
    jax_net = JaxClassifier(n_classes=3, seed=0)
    net = PixelClassifier(3, device="cpu")
    net.variables = jax.tree_util.tree_map(np.asarray, jax_net.variables)
    banded = Predictor(PredictSettings(color_map=DEFAULT_IMAGE_MAP, n_classes=3, band_rows=192),
                       network=net)
    plain = Predictor(PredictSettings(color_map=DEFAULT_IMAGE_MAP, n_classes=3), network=net)
    jax_banded = JaxPredictor(JaxSettings(color_map=JAX_MAP, n_classes=3, band_rows=192),
                              network=jax_net)
    rng = np.random.RandomState(0)
    image = (rng.rand(712, 64) * 255).astype(np.uint8)
    tall = SingleData(image=image, binary=np.ones((712, 64), np.uint8))
    assert banded._use_banded(tall) and not plain._use_banded(tall)
    got = banded.predict_single(tall)
    want = jax_banded.predict_single(JaxData(image=image, binary=np.ones((712, 64), np.uint8)))
    np.testing.assert_array_equal(got.labels, want.labels)
    np.testing.assert_array_equal(got.labels, plain.predict_single(tall).labels)
    np.testing.assert_allclose(got.probabilities, want.probabilities, atol=1e-5)
    short = SingleData(image=image[:96], binary=np.ones((96, 64), np.uint8))
    assert not banded._use_banded(short)


def test_efficientnet_is_never_banded():
    with torch.device("meta"):
        net = PixelClassifier.__new__(PixelClassifier)
    net.architecture = Architecture.EFFNETB0
    predictor = Predictor(PredictSettings(n_classes=3, band_rows=64), network=net)
    tall = SingleData(image=np.zeros((4096, 64), np.uint8))
    assert "effb0" not in spatial.DEFAULT_MARGINS and not predictor._use_banded(tall)


def test_several_devices_raise_naming_item_12b():
    # ported: spatial partitioning over several devices runs
    # (tests/test_torch_spatial_mesh.py holds it against the JAX package);
    # with both options a page above the threshold takes the mesh, not bands
    net = PixelClassifier(3, device="cpu")
    predictor = Predictor(PredictSettings(n_classes=3, n_devices=2, spatial_threshold=1,
                                          band_rows=64), network=net)
    tall = SingleData(image=np.zeros((704, 40), np.uint8), binary=np.ones((704, 40), np.uint8))
    assert predictor._spatial_mesh.devices.size == 2
    assert predictor._use_spatial(tall) and predictor._use_banded(tall)
    image = np.random.RandomState(0).rand(704, 40, 1).astype(np.float32)
    banded = spatial.banded_forward(net.module, image, band_rows=192, margin=80)
    split = spatial.spatial_forward(net.module, image, predictor._spatial_mesh, margin=80)
    np.testing.assert_allclose(split, banded, atol=5e-4)
    np.testing.assert_array_equal(split.argmax(-1), banded.argmax(-1))


def test_cli_band_rows_labels_equal_the_unbanded_and_jax(tmp_path):
    from page_segmentation_tpu.cli.main import main as jax_main
    from page_segmentation_tpu.train.checkpoint import save_checkpoint
    from page_segmentation_tpu_torch.cli.main import main
    from page_segmentation_tpu_torch.core.image_io import imread, imsave
    from page_segmentation_tpu_torch.models.bridge import init_params_numpy

    for sub in ("images", "binary"):
        (tmp_path / sub).mkdir()
    rng = np.random.RandomState(5)
    page = np.full((720, 48), 235, np.uint8)
    for row in range(8, 700, 20):
        page[row : row + 8, 4 : rng.randint(12, 44)] = 30
    imsave(tmp_path / "images" / "tall.png", page)
    imsave(tmp_path / "binary" / "tall.png", np.where(page >= 128, 255, 0).astype(np.uint8))
    ckpt = str(tmp_path / "model")
    save_checkpoint(ckpt, {"params": init_params_numpy(3, 0)}, {"architecture": "fcn_skip"})
    common = ["--load", ckpt, "--images", str(tmp_path / "images"), "--binary",
              str(tmp_path / "binary"), "--char_height", "6"]
    banded = ["--band_rows", "192"]
    assert main(["predict", "--device", "cpu", "--output", str(tmp_path / "b")] + common + banded) == 0
    assert main(["predict", "--device", "cpu", "--output", str(tmp_path / "u")] + common) == 0
    assert jax_main(["predict", "--output", str(tmp_path / "j")] + common + banded) == 0
    got = imread(tmp_path / "b" / "color" / "tall.png")
    assert got.shape == (720, 48, 3)
    np.testing.assert_array_equal(got, imread(tmp_path / "u" / "color" / "tall.png"))
    np.testing.assert_array_equal(got, imread(tmp_path / "j" / "color" / "tall.png"))


def test_rgb_family_bands_equal_its_whole_page():
    """The JAX package's banded route hands an RGB family the gray page with
    one channel (its stem then raises ScopeParamShapeError); the port
    repeats it to three channels, as the classifier's own forward does."""
    net = PixelClassifier(3, architecture=Architecture.MOBILE_NET, device="cpu", seed=1)
    banded = Predictor(PredictSettings(n_classes=3, band_rows=192), network=net)
    image = (np.random.RandomState(2).rand(704, 64) * 255).astype(np.uint8)
    tall = SingleData(image=image)
    assert banded._use_banded(tall)
    logit, _, pred = banded._banded_single_data(tall)
    want_logit, _, want = net.predict_single_data(tall)
    np.testing.assert_allclose(logit, want_logit, atol=5e-4)
    np.testing.assert_array_equal(banded.predict_single(tall).labels, want)
