"""The port's int8 post-training quantization (``models/quant.py``) against
the JAX package's, on the CPU.

Gates: on an exact integer grid (scale 1) the int8 layers equal the float
layers exactly, for every conv shape of the FCN plan; with the JAX
package's ``amax`` carried across, conv1's int32 accumulators and the int8
logits equal the JAX package's bit for bit (the integer GEMM is exact and
every float step is the same IEEE operation in the same order); the
port's own calibration is within 1e-5 relative of the JAX package's (float
convolutions summed in another order); the float mode equals
``models/fcn.py`` bit for bit; the int8 logits stay within 0.05 of the
float logits' scale.  The predict paths (``PixelClassifier``,
``ThroughputPredictor`` with the host and the device vote,
``RawCorpusPredictor``) match the JAX package's labels: exactly where the
inputs are the same and ``amax`` is carried, on >= 99.9 % of pixels where
each package resamples and calibrates on its own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP as JAX_MAP
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.inference.corpus import RawCorpusPredictor as JaxCorpus
from page_segmentation_tpu.inference.corpus import RawPage as JaxPage
from page_segmentation_tpu.inference.pipeline import ThroughputPredictor as JaxThroughput
from page_segmentation_tpu.models import quant as jax_quant
from page_segmentation_tpu.models.fcn import FCN as JaxFCN
from page_segmentation_tpu.models.fcn import FCNSkip as JaxFCNSkip
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.core.image_io import imsave
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.corpus import RawCorpusPredictor, RawPage
from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
from page_segmentation_tpu_torch.models import quant
from page_segmentation_tpu_torch.models.bridge import (
    amax_from_jax, amax_to_jax, init_params_numpy, params_from_jax)
from page_segmentation_tpu_torch.models.fcn import FCN, FCNSkip
from page_segmentation_tpu_torch.models.registry import Architecture

PALETTE = DEFAULT_IMAGE_MAP.palette


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    tree = init_params_numpy(3, seed=0)
    rng = np.random.default_rng(1)
    for leaves in tree.values():
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    return tree


def _module(cls, params):
    module = cls(3)
    module.load_state_dict(params_from_jax(params))
    return module


def _synthetic_page(h, w, seed=0):
    """Text bars on light ground (the JAX test's page)."""
    rng = np.random.RandomState(seed)
    page = np.full((h, w), 235, np.uint8)
    for row in range(h // 8, h - 16, 24):
        for col in range(w // 10, w - 12, 14):
            if rng.rand() < 0.8:
                page[row : row + 12, col : col + 8] = rng.randint(10, 60)
    return page


# ---------------------------------------------------------------- layers
def _layer_state(kernel, bias):
    """One layer's state dict from its JAX kernel (Keras layout) and bias."""
    return {"weight": torch.from_numpy(np.ascontiguousarray(kernel.transpose(3, 2, 0, 1))),
            "bias": torch.from_numpy(bias)}


LAYERS = [  # (transpose, cin, cout, kernel, stride)
    (False, 3, 4, (2, 2), (1, 1)),
    (False, 3, 5, (5, 5), (1, 1)),
    (False, 50, 3, (1, 1), (1, 1)),
    (True, 3, 4, (2, 2), (2, 2)),
    (True, 6, 5, (5, 5), (1, 1)),
]


@pytest.mark.parametrize("transpose, cin, cout, kernel, stride", LAYERS)
def test_qconv_exact_on_the_integer_grid(transpose, cin, cout, kernel, stride):
    """Integer inputs and weights with amax 127 quantize losslessly, so the
    int8 layer equals the float layer exactly, and equals the JAX QConv."""
    rng = np.random.RandomState(0)
    x = rng.randint(-127, 128, (2, 8, 8, cin)).astype(np.float32)
    x.flat[0] = 127.0
    kshape = kernel + ((cout, cin) if transpose else (cin, cout))  # Keras layouts
    k = rng.randint(-127, 128, kshape).astype(np.float32)
    if transpose:
        k[0, 0, :, 0] = 127.0
    else:
        k[0, 0, 0, :] = 127.0
    bias = rng.randn(cout).astype(np.float32)
    cls = quant.QConvTranspose if transpose else quant.QConv
    layer = cls(cin, cout, kernel, stride, mode="int8")
    layer.load_state_dict(_layer_state(k, bias))
    layer.amax.fill_(127.0)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = layer(xt)
        layer.mode = "float"
        want = layer(xt)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    jax_layer = jax_quant.QConv(cout, kernel, strides=stride, transpose=transpose, mode="int8")
    jax_out = jax_layer.apply({"params": {"kernel": k, "bias": bias},
                               "amax": {"in": np.float32(127.0)}}, x)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(jax_out))


def test_patch_chunks_give_the_same_accumulators(monkeypatch):
    layer = quant.QConv(3, 4, (5, 5), mode="int8")
    layer.load_state_dict(_layer_state(np.random.RandomState(1).randn(5, 5, 3, 4).astype(np.float32),
                                       np.zeros(4, np.float32)))
    layer.amax.fill_(1.0)
    x = torch.from_numpy(np.random.RandomState(2).randn(5, 3, 16, 8).astype(np.float32))
    whole = layer.accumulate(x)
    monkeypatch.setattr(quant, "PATCH_BYTES", 16 * 8 * 3 * 25 * 2)  # two pages a chunk
    np.testing.assert_array_equal(layer.accumulate(x).numpy(), whole.numpy())


def test_calibrate_keeps_the_running_max():
    cal, _ = quant.QuantFCNSkip.pair(3)
    cal.load_state_dict(params_from_jax(init_params_numpy(3, 0)))
    big = np.full((1, 8, 8, 1), 5.0, np.float32)
    small = np.full((1, 8, 8, 1), 2.0, np.float32)
    assert float(quant.calibrate(cal, [big, small])["conv1"]["in"]) == 5.0
    assert float(quant.calibrate(cal, [small])["conv1"]["in"]) == 2.0  # from zero again
    with pytest.raises(ValueError, match="batch"):
        quant.calibrate(cal, [])


# ---------------------------------------------------------------- models
@pytest.fixture(scope="module")
def jax_int8(params):
    """The JAX int8 run: calibrated on x, and its logits."""
    x = np.random.RandomState(2).rand(2, 48, 40, 1).astype(np.float32)
    q, variables = jax_quant.quantize_for_inference("fcn_skip", 3, params, [x])
    return x, variables["amax"], np.asarray(q.apply(variables, x))


def test_int8_logits_equal_jax_bit_for_bit(params, jax_int8):
    x, amax, want = jax_int8
    _, q = quant.twin_classes_for(_module(FCNSkip, params))
    amax_from_jax(q, amax)
    assert amax_to_jax(q).keys() == amax.keys()
    with torch.no_grad():
        got = q(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # conv1's accumulators: the JAX package's quantize and integer conv
    s_in = np.maximum(amax["conv1"]["in"], 1e-12) / 127.0
    kernel = params["conv1"]["kernel"]
    s_w = np.maximum(np.abs(kernel).max(axis=(0, 1, 2), keepdims=True), 1e-12) / 127.0
    jax_acc = lax.conv_general_dilated(
        jax_quant._quantize_symmetric(jnp.asarray(x), s_in),
        jax_quant._quantize_symmetric(jnp.asarray(kernel), s_w), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32)
    acc = q.conv1.accumulate(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.permute(0, 2, 3, 1).numpy(), np.asarray(jax_acc))


def test_own_calibration_is_close_to_jax(params, jax_int8):
    x, amax, _ = jax_int8
    cal, _ = quant.twin_classes_for(_module(FCNSkip, params))
    got = quant.calibrate(cal, [x])
    assert got.keys() == amax.keys()
    for name in amax:
        want = float(amax[name]["in"])
        assert abs(float(got[name]["in"]) - want) <= 1e-5 * want, name


@pytest.mark.parametrize("cls, jax_cls", [(FCNSkip, JaxFCNSkip), (FCN, JaxFCN)])
def test_float_mode_equals_the_fcn_bit_for_bit(params, cls, jax_cls):
    tree = init_params_numpy(3, 0, skips=cls is FCNSkip)
    module = _module(cls, tree)
    cal, q = quant.twin_classes_for(module)
    twin = type(q)(3, mode="float")
    twin.load_state_dict(module.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).rand(1, 48, 40, 1).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(twin(x).numpy(), module(x).numpy())
        np.testing.assert_array_equal(cal(x).numpy(), module(x).numpy())  # calibrate runs float


def test_int8_logit_error_is_bounded(params):
    x = np.random.RandomState(2).rand(2, 48, 40, 1).astype(np.float32)
    module = _module(FCNSkip, params)
    q, amax = quant.quantize_for_inference("fcn_skip", 3, params, [x], device="cpu")
    with torch.no_grad():
        ref, out = module(torch.from_numpy(x)).numpy(), q(torch.from_numpy(x)).numpy()
    assert np.abs(out - ref).max() <= 0.05 * np.abs(ref).max()
    assert (out.argmax(-1) == ref.argmax(-1)).mean() >= 0.9


def test_rgb_and_unknown_architectures_raise():
    with pytest.raises(ValueError, match="fcn"):
        quant.quantize_for_inference("mobile_net", 3, {}, [], device="cpu")
    with pytest.raises(ValueError, match="grayscale"):
        quant.twin_classes_for(Architecture.UNET.model(3))
    rgb = PixelClassifier(3, architecture=Architecture.MOBILE_NET, int8=True, device="cpu")
    pages = np.zeros((1, 64, 64), np.uint8)
    with pytest.raises(ValueError, match="grayscale"):
        rgb.predict_batch_masks(pages, pages, PALETTE)
    with pytest.raises(ValueError, match="grayscale"):
        ThroughputPredictor(Architecture.MOBILE_NET.model(3), None, PALETTE, (64, 64), 0.5,
                            int8=True, preprocess_mode="tf", device="cpu")
    with pytest.raises(ValueError, match="grayscale"):
        RawCorpusPredictor(rgb, PALETTE, int8=True)


# ------------------------------------------------------------ predict paths
@pytest.mark.parametrize("device_vote", [False, True])
def test_classifier_int8_labels_equal_jax(params, device_vote):
    h, w = 96, 80
    images = np.stack([_synthetic_page(h, w, s) for s in range(2)])
    binaries = (images < 128).astype(np.uint8)
    jax_net = JaxClassifier(n_classes=3, int8=True)
    jax_net.params = params
    net = PixelClassifier(3, int8=True, device="cpu")
    net.params = params
    want_pred, want_masks = jax_net.predict_batch_masks(images, binaries, PALETTE,
                                                        device_vote=device_vote)
    got_pred, got_masks = net.predict_batch_masks(images, binaries, PALETTE,
                                                  device_vote=device_vote)
    for name, want in jax_net._int8_state[1].items():  # each calibrated its own
        assert abs(float(net.amax[name]["in"]) - float(want["in"])) <= 1e-5 * float(want["in"])
    assert (got_pred == want_pred).mean() >= 0.999
    net.amax = jax_net._int8_state[1]  # the same ranges: the same labels
    got_pred, got_masks = net.predict_batch_masks(images, binaries, PALETTE,
                                                  device_vote=device_vote)
    np.testing.assert_array_equal(got_pred, want_pred)
    np.testing.assert_array_equal(got_masks, np.asarray(want_masks))
    float_pred, _ = PixelClassifier(3, device="cpu", seed=0).predict_batch_masks(
        images, binaries, PALETTE)
    assert got_pred.shape == float_pred.shape


def test_new_weights_recalibrate_in_the_port_not_in_the_jax_package(params):
    """A fault of the JAX package: its classifier keeps the int8 ranges of
    its first weights (``_int8_state``) after ``params`` changes; the
    port's drops them and calibrates the new weights afresh."""
    images = np.stack([_synthetic_page(96, 80, s) for s in range(2)])
    binaries = (images < 128).astype(np.uint8)
    scaled = {layer: {k: v * 3.0 for k, v in leaves.items()} for layer, leaves in params.items()}
    jax_net = JaxClassifier(n_classes=3, int8=True)
    net = PixelClassifier(3, int8=True, device="cpu")
    first = {}
    for classifier in (jax_net, net):
        classifier.params = params
        classifier.predict_batch_masks(images, binaries, PALETTE)
        if classifier is jax_net:
            first = {n: float(a["in"]) for n, a in jax_net._int8_state[1].items()}
        classifier.params = scaled
        classifier.predict_batch_masks(images, binaries, PALETTE)
    fresh_jax = JaxClassifier(n_classes=3, int8=True)
    fresh_jax.params = scaled
    fresh_jax.predict_batch_masks(images, binaries, PALETTE)
    for name, want in fresh_jax._int8_state[1].items():
        assert float(jax_net._int8_state[1][name]["in"]) == first[name]  # the first weights' range
        assert abs(float(net.amax[name]["in"]) - float(want["in"])) <= 1e-5 * float(want["in"])
    assert any(first[n] != float(w["in"]) for n, w in fresh_jax._int8_state[1].items())


@pytest.mark.parametrize("cc_vote, download", [("host", "packed"), ("pallas", "pred")])
def test_throughput_int8_labels_equal_jax(params, cc_vote, download):
    h, w = 192, 160
    pages = np.stack([_synthetic_page(h, w, s) for s in range(2)])
    binaries = ((pages >= 128) * 255).astype(np.uint8)
    kw = dict(page_shape=(h, w), scale=0.5, host_decimate=2, yield_pred=True, download=download)
    jax_tp = JaxThroughput(JaxFCNSkip(n_classes=3), params, JAX_MAP.palette, int8=True,
                           cc_vote="xla" if cc_vote == "pallas" else cc_vote, **kw)
    want = [np.asarray(b[0]) for b in jax_tp.run(pages, binaries, batch_size=2)]
    tp = ThroughputPredictor(_module(FCNSkip, params), None, PALETTE, int8=True,
                             cc_vote=cc_vote, device="cpu", **kw)
    assert tp.amax is None
    got = [b[0] for b in tp.run(pages, binaries, batch_size=2)]
    assert tp.amax is not None  # calibrated on the first batch
    agree = np.concatenate(got) == np.concatenate(want)
    assert agree.mean() >= 0.999, agree.mean()


def test_raw_corpus_int8_matches_jax(params, tmp_path):
    pages, jax_pages = [], []
    for i in range(2):
        page = _synthetic_page(192, 160, i)
        imsave(tmp_path / f"p{i}.png", page)
        imsave(tmp_path / f"b{i}.png", ((page >= 128) * 255).astype(np.uint8))
        pages.append(RawPage(str(tmp_path / f"p{i}.png"), str(tmp_path / f"b{i}.png"), 12))
        jax_pages.append(JaxPage(str(tmp_path / f"p{i}.png"), str(tmp_path / f"b{i}.png"), 12))
    net = PixelClassifier(3, device="cpu")
    net.params = params
    jax_net = JaxClassifier(n_classes=3)
    jax_net.params = params
    jax_runner = JaxCorpus(jax_net, JAX_MAP.palette, batch_size=2, int8=True,
                           compute_dtype=jnp.float32)
    want = list(jax_runner.run(jax_pages))
    (key, jax_tp), = jax_runner._predictors.items()

    def run(amax=None):
        runner = RawCorpusPredictor(net, PALETTE, batch_size=2, int8=True,
                                    compute_dtype=torch.float32)
        if amax is not None:  # the group's predictor, as run() will key it
            runner._predictor_for(key[:3], packed_binary=key[3]).amax = amax
        got = list(runner.run(pages))
        assert [p.name for p, *_ in got] == [p.name for p, *_ in want]
        return [(color == jax_color).all(-1).mean()
                for (_, color, *_), (_, jax_color, *_) in zip(got, want)]

    # each calibrated on its own resample: int8 rounding flips a few near-ties
    assert min(run()) >= 0.99
    assert min(run(jax_tp.variables["amax"])) == 1.0


def test_serve_int8_fused_equals_direct_throughput_predictor():
    from page_segmentation_tpu_torch.inference.corpus import pick_host_decimate
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.inference.server import BatchingService

    network = PixelClassifier(3, seed=0, device="cpu")
    svc = BatchingService(Predictor(PredictSettings(color_map=DEFAULT_IMAGE_MAP, n_classes=3,
                                                    int8=True), network=network),
                          DEFAULT_IMAGE_MAP, target_line_height=8, default_char_height=8,
                          max_batch=4, max_wait_ms=10.0)
    try:
        page = _synthetic_page(96, 80, 3)
        got = svc.submit(page).result(timeout=120)
        (fused,) = svc._fused_predictors.values()
    finally:
        svc.stop()
    assert fused.int8 and fused.amax is not None
    tp = ThroughputPredictor(network.module, None, PALETTE, page.shape, 1.0,
                             host_decimate=pick_host_decimate(1.0),
                             compute_dtype=network.compute_dtype, download="packed",
                             int8=True, yield_pred=True, device="cpu")
    tp.amax = fused.amax
    binary = np.where(page >= 128, np.uint8(255), np.uint8(0))
    (pred, color, _, _), = list(tp.run(page[None], binary[None], batch_size=1))
    np.testing.assert_array_equal(got["labels"], pred[0])
    np.testing.assert_array_equal(got["color"], color[0])


@pytest.mark.parametrize("route", [["--fast"], ["--pipeline"]])
def test_cli_int8_matches_the_jax_cli(params, tmp_path, route):
    from page_segmentation_tpu.cli.main import main as jax_main
    from page_segmentation_tpu.train.checkpoint import save_checkpoint
    from page_segmentation_tpu_torch.cli.main import main
    from page_segmentation_tpu_torch.core.image_io import imread

    for sub in ("images", "binary"):
        (tmp_path / sub).mkdir()
    for i in range(2):
        page = _synthetic_page(192, 160, i)
        imsave(tmp_path / "images" / f"p{i}.png", page)
        imsave(tmp_path / "binary" / f"p{i}.png", ((page >= 128) * 255).astype(np.uint8))
    ckpt = str(tmp_path / "model")
    save_checkpoint(ckpt, {"params": params}, {"architecture": "fcn_skip", "n_classes": 3})
    common = ["--load", ckpt, "--images", str(tmp_path / "images"), "--binary",
              str(tmp_path / "binary"), "--char_height", "12", "--int8", "--batch_size", "2"]
    assert main(["predict", "--device", "cpu", "--output", str(tmp_path / "port")]
                + common + route) == 0
    assert jax_main(["predict", "--output", str(tmp_path / "jax")] + common + route) == 0
    for name in ("p0.png", "p1.png"):
        got = imread(tmp_path / "port" / "color" / name)
        want = imread(tmp_path / "jax" / "color" / name)
        assert got.shape == want.shape
        # each package calibrates on its own first batch
        assert (got == want).all(-1).mean() >= 0.99
