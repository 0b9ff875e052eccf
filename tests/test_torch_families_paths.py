"""One RGB family (mobile_net) and UNet through the port's predict paths
against the JAX package's, from one checkpoint both load (float32 on both
sides): the throughput path (``ThroughputPredictor``), the per-page batch
path (``PixelClassifier.predict_batch_masks``) and the raw-corpus streamer
(``RawCorpusPredictor``), and the batching service's fused route
(``BatchingService``).

Each path keeps its JAX counterpart's padding convention for the RGB
preprocess modes: the throughput program zero-pads after preprocessing, the
batch path preprocesses the padded page.  Tolerances: labels agree on >=
99.9 % of pixels (convolutions summed in another order flip near-ties) and
every product of the labels (trio, voted labels) is byte-equal wherever
they agree.  The weights are seeded with BatchNorm statistics calibrated on
the pages the test predicts."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu.inference import pipeline as jax_pipeline
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.inference.corpus import RawCorpusPredictor as JaxCorpus
from page_segmentation_tpu.inference.corpus import RawPage as JaxPage
from page_segmentation_tpu.inference.postprocess import find_postprocessor as jax_find
from page_segmentation_tpu.inference.predictor import Predictor as JaxPredictor
from page_segmentation_tpu.inference.predictor import PredictSettings as JaxSettings
from page_segmentation_tpu.inference.server import BatchingService as JaxService
from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP as PORT_MAP
from page_segmentation_tpu_torch.core.image_io import imsave
from page_segmentation_tpu_torch.inference import pipeline
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.corpus import RawCorpusPredictor, RawPage
from page_segmentation_tpu_torch.inference.postprocess import find_postprocessor
from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
from page_segmentation_tpu_torch.inference.server import BatchingService
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax, params_to_jax
from page_segmentation_tpu_torch.models.layers import calibrate_batch_stats
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.ops.pad import round_up
from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

PAGE = (400, 296)
SCALE = 6 / 50
NORMALIZED = (int(np.round(PAGE[0] * SCALE)), int(np.round(PAGE[1] * SCALE)))
PALETTE = DEFAULT_IMAGE_MAP.palette
FAMILIES = ["mobile_net", "unet"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pages(n, seed):
    """Full-resolution pages: paper, dark glyph blocks; binary 0 on ink."""
    rng = np.random.default_rng(seed)
    pages = np.full((n,) + PAGE, 230, np.uint8)
    for i in range(n):
        for _ in range(40):
            y, x = rng.integers(0, PAGE[0] - 40), rng.integers(0, PAGE[1] - 30)
            pages[i, y : y + rng.integers(10, 40), x : x + rng.integers(8, 30)] = rng.integers(5, 80)
    pages = np.clip(pages + rng.normal(0, 4, pages.shape), 0, 255).astype(np.uint8)
    return pages, np.where(pages < 128, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def pages():
    return _pages(2, 0)


@pytest.fixture(scope="module", params=FAMILIES)
def checkpoint(request, pages, tmp_path_factory):
    """The family's seeded weights, BatchNorm calibrated on the test pages
    as the throughput program normalizes them, saved by the port."""
    arch = Architecture(request.param)
    module = arch.model(3)
    module.load_state_dict(params_from_jax(init_variables_numpy(module, 0)))
    out_h, out_w = NORMALIZED
    pad_h, pad_w = round_up(out_h, arch.stride_factor), round_up(out_w, arch.stride_factor)
    dec = native.decimate_u8(pages[0], 8)
    calibrate_batch_stats(module, pipeline._device_normalize(
        out_h, out_w, pad_h, pad_w, arch.preprocess_mode)(torch.from_numpy(dec)))
    variables = params_to_jax(module.state_dict())
    variables = variables if "params" in variables else {"params": variables}
    path = str(tmp_path_factory.mktemp(arch.value) / "model")
    save_checkpoint(path, variables, {"architecture": arch.value, "n_classes": 3})
    return arch, path


def _classifiers(checkpoint):
    arch, path = checkpoint
    port = PixelClassifier(3, model_path=path, device="cpu")
    jax_cls = JaxClassifier(3, model_path=path, compute_dtype=jnp.float32)
    assert port.architecture is arch and jax_cls.architecture.value == arch.value
    return port, jax_cls


def _assert_agree(got_pred, want_pred, got_products, want_products, bar=0.999):
    agree = got_pred == want_pred
    assert agree.mean() >= bar, f"label agreement {agree.mean():.6f}"
    for g, w in zip(got_products, want_products):
        np.testing.assert_array_equal(g[agree], w[agree])


def test_device_normalize_matches_jax_for_every_mode(pages):
    dec = native.decimate_u8(pages[0], 8)
    out_h, out_w = NORMALIZED
    for mode in ("gray", "caffe", "tf", "torch"):
        want = np.asarray(jax_pipeline._device_normalize(out_h, out_w, 64, 64, mode)(jnp.asarray(dec)))
        got = pipeline._device_normalize(out_h, out_w, 64, 64, mode)(torch.from_numpy(dec))
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape
        scale = 255.0 if mode == "gray" else 1.0  # 0.01 gray levels through each mode's scale
        np.testing.assert_allclose(got, want, atol=0.02 / scale if mode != "caffe" else 0.02)
        assert not got[:, out_h:].any() and not got[:, :, out_w:].any()  # padded after preprocessing


@pytest.mark.parametrize("cc_vote", ["host", "pallas"])
def test_throughput_run_matches_jax(checkpoint, pages, cc_vote):
    port, jax_cls = _classifiers(checkpoint)
    arch = port.architecture
    common = dict(host_decimate=8, stride_factor=arch.stride_factor, download="packed",
                  preprocess_mode=arch.preprocess_mode, yield_pred=True)
    torch_tp = pipeline.ThroughputPredictor(port.module, None, PALETTE, PAGE, SCALE,
                                            compute_dtype=torch.float32, cc_vote=cc_vote,
                                            device="cpu", **common)
    jax_tp = jax_pipeline.ThroughputPredictor(jax_cls.module, jax_cls.variables, PALETTE, PAGE, SCALE,
                                              compute_dtype=jnp.float32,
                                              cc_vote="xla" if cc_vote == "pallas" else cc_vote,
                                              **common)
    got = list(torch_tp.run(*pages, batch_size=2))
    want = list(jax_tp.run(*pages, batch_size=2))
    assert len(got) == len(want) == 1
    (gp, *gtrio), (wp, *wtrio) = got[0], want[0]
    assert gp.shape == (2,) + NORMALIZED
    _assert_agree(gp, wp, gtrio, wtrio)


@pytest.mark.parametrize("device_vote", [False, True])
def test_predict_batch_masks_matches_jax(checkpoint, pages, device_vote):
    """The padded prepared page is what the RGB families preprocess, so the
    padding becomes their normalized 0 (-1 for 'tf'), as in the JAX path."""
    port, jax_cls = _classifiers(checkpoint)
    stride = port.architecture.stride_factor
    shape = (round_up(NORMALIZED[0] + 3, stride), round_up(NORMALIZED[1] + 3, stride))
    images = np.zeros((2,) + shape, np.uint8)
    binaries = np.zeros_like(images)
    dec = native.decimate_u8(pages[0], 8)
    images[:, : dec.shape[1], : dec.shape[2]] = 255 - dec  # prepared pages: ink bright
    binaries[:, : dec.shape[1], : dec.shape[2]] = dec < 128
    got = port.predict_batch_masks(images, binaries, PALETTE, device_vote=device_vote)
    want = jax_cls.predict_batch_masks(images, binaries, PALETTE, device_vote=device_vote)
    assert got[0].shape == want[0].shape == (2,) + shape
    _assert_agree(got[0], np.asarray(want[0]), got[1], np.asarray(want[1]))


def test_raw_corpus_streamer_matches_jax(checkpoint, tmp_path):
    port, jax_cls = _classifiers(checkpoint)
    images, binaries = _pages(3, 5)
    ports, jaxes = [], []
    for i in range(3):
        image_path, binary_path = str(tmp_path / f"p{i}.png"), str(tmp_path / f"b{i}.png")
        imsave(image_path, images[i])
        imsave(binary_path, binaries[i])
        ports.append(RawPage(image_path, binary_path, 50))
        jaxes.append(JaxPage(image_path, binary_path, 50))
    runner = RawCorpusPredictor(port, PALETTE, batch_size=2, compute_dtype=torch.float32,
                                cc_vote="pallas")
    got = {p.name: trio for p, *trio in runner.run(ports)}
    want = {p.name: trio for p, *trio in JaxCorpus(jax_cls, PALETTE, batch_size=2,
                                                   compute_dtype=jnp.float32, cc_vote="xla").run(jaxes)}
    assert got.keys() == want.keys()

    def labels(color):
        return (color[..., None, :] == PALETTE).all(-1).argmax(-1)

    for name in want:
        _assert_agree(labels(got[name][0]), labels(want[name][0]), got[name], want[name])


def test_service_fused_route_matches_jax(checkpoint, pages):
    """The service's fused route runs the family's preprocess mode."""
    port, jax_cls = _classifiers(checkpoint)
    port_service = BatchingService(
        Predictor(PredictSettings(color_map=PORT_MAP, n_classes=3,
                                  post_process=[find_postprocessor("cc_majority")]), network=port),
        PORT_MAP, target_line_height=6, default_char_height=50)
    jax_service = JaxService(
        JaxPredictor(JaxSettings(color_map=DEFAULT_IMAGE_MAP, n_classes=3,
                                 post_process=[jax_find("cc_majority")]), network=jax_cls),
        DEFAULT_IMAGE_MAP, target_line_height=6, default_char_height=50)
    try:
        assert port_service.prepare == "fused"
        got = [port_service.submit(p).result(timeout=120) for p in pages[0]]
        want = [jax_service.submit(p).result(timeout=300) for p in pages[0]]
    finally:
        port_service.stop()
        jax_service.stop()
    trio = ("color", "overlay", "inverted")
    for g, w in zip(got, want):
        assert g["labels"].shape == w["labels"].shape == NORMALIZED
        _assert_agree(g["labels"], w["labels"], [g[k] for k in trio], [w[k] for k in trio])
