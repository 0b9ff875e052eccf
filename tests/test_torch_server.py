"""The port's batching service and HTTP front end (``inference/server.py``),
mirroring ``tests/test_server.py``, on the CPU.

Tolerances: the fused service equals a direct
``ThroughputPredictor(yield_pred=True)`` run exactly and the spline service
equals ``Predictor.predict_dataset_fast`` exactly (same page, same batch
size).  Against the JAX package's service on the same request in float32
the labels agree on >= 99.99 % of pixels (other summation order in the
convolutions), and the trio is byte-equal wherever they agree."""
import json
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP as JAX_MAP
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.inference.predictor import Predictor as JaxPredictor
from page_segmentation_tpu.inference.predictor import PredictSettings as JaxSettings
from page_segmentation_tpu.inference.server import BatchingService as JaxService
from page_segmentation_tpu_torch.cli.main import build_parser
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.core.image_io import decode_image_bytes, encode_png
from page_segmentation_tpu_torch.data.dataset import SingleData
from page_segmentation_tpu_torch.data.loader import DatasetLoader
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.corpus import pick_host_decimate
from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
from page_segmentation_tpu_torch.inference.postprocess import find_postprocessor
from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
from page_segmentation_tpu_torch.inference.server import (
    BatchingService,
    PredictionServer,
    ServiceOverloaded,
)
from page_segmentation_tpu_torch.models.bridge import init_params_numpy
from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint


def make_page(seed: int = 0, h: int = 64, w: int = 48):
    rng = np.random.RandomState(seed)
    page = np.full((h, w), 240, np.uint8)
    page[20:44, 12:36] = rng.randint(10, 60, (24, 24)).astype(np.uint8)
    return page


def text_page(seed: int, h: int = 400, w: int = 300):
    """A page of 16 px text lines and a figure strip."""
    rng = np.random.RandomState(seed)
    page = np.full((h, w), 235, np.uint8)
    for row in range(8, h - 40, 26):
        for col in range(6, w - 24, 30):
            if rng.rand() < 0.8:
                page[row : row + 16, col : col + 20] = rng.randint(10, 60)
    page[-30:-6, 4 : w // 2] = 120
    return page


def _predictor(post_process=None, **settings):
    network = PixelClassifier(3, seed=0, device="cpu")
    return Predictor(PredictSettings(color_map=DEFAULT_IMAGE_MAP, n_classes=3,
                                     post_process=post_process, **settings), network=network)


def _service(post_process=None, **kwargs):
    kwargs = {"target_line_height": 8, "default_char_height": 8, "max_batch": 8,
              "max_wait_ms": 60.0, **kwargs}
    return BatchingService(_predictor(post_process), DEFAULT_IMAGE_MAP, **kwargs)


@pytest.fixture(scope="module")
def service():
    svc = _service()
    yield svc
    svc.stop()


def _binary(page):
    return np.where(page >= 128, np.uint8(255), np.uint8(0))


@pytest.mark.parametrize("post", [None, "cc_majority"])
def test_fused_service_equals_direct_throughput_predictor(post):
    svc = _service([find_postprocessor(post)] if post else None)
    try:
        assert svc.prepare == "fused"
        page = make_page(3)
        got = svc.submit(page).result(timeout=120)
        net = svc.predictor.network
        tp = ThroughputPredictor(
            net.module, None, DEFAULT_IMAGE_MAP.palette, page.shape, 1.0,
            host_decimate=pick_host_decimate(1.0), compute_dtype=net.compute_dtype,
            download="packed", cc_vote="host" if post else False, yield_pred=True, device="cpu")
        (pred, color, overlay, inverted), = list(tp.run(page[None], _binary(page)[None], batch_size=1))
        for key, want in (("labels", pred), ("color", color), ("overlay", overlay),
                          ("inverted", inverted)):
            np.testing.assert_array_equal(got[key], want[0])
    finally:
        svc.stop()


@pytest.mark.parametrize("post", [None, "cc_majority"])
def test_spline_service_equals_predict_dataset_fast(post):
    svc = _service([find_postprocessor(post)] if post else None, prepare="spline")
    try:
        page = make_page(0)
        got = svc.submit(page).result(timeout=120)
        dataset = DatasetLoader(8, DEFAULT_IMAGE_MAP, prediction=True).load_data(
            [SingleData(image=page.copy(), binary=_binary(page), line_height_px=8)])
        (_, pred, color, overlay, inverted), = list(
            svc.predictor.predict_dataset_fast(dataset, batch_size=1))
        for key, want in (("labels", pred), ("color", color), ("overlay", overlay),
                          ("inverted", inverted)):
            np.testing.assert_array_equal(got[key], want)
    finally:
        svc.stop()


@pytest.mark.parametrize("config", ["max_width", "bounding_boxes", "high_res_output"])
def test_fused_falls_back_when_ineligible(config):
    if config == "max_width":
        svc = _service(max_width=40)
    elif config == "bounding_boxes":
        svc = _service([find_postprocessor("bounding_boxes")])
    else:
        svc = BatchingService(_predictor(high_res_output=True), DEFAULT_IMAGE_MAP, default_char_height=8)
    try:
        assert svc.prepare == "spline"
        assert svc.submit(make_page(1)).result(timeout=120)["labels"].ndim == 2
    finally:
        svc.stop()


def test_concurrent_requests_share_batches(service):
    batches_before = service.stats.batches_total
    futures = [service.submit(make_page(i)) for i in range(6)]
    results = [f.result(timeout=120) for f in futures]
    assert all(r["labels"].shape == (64, 48) for r in results)
    new_batches = service.stats.batches_total - batches_before
    assert 1 <= new_batches < 6
    assert max(list(service.stats.batch_sizes)[-new_batches:]) >= 2


def test_submit_requires_char_height():
    svc = BatchingService(_predictor(), DEFAULT_IMAGE_MAP, target_line_height=8)
    try:
        with pytest.raises(ValueError, match="char_height"):
            svc.submit(make_page(0))
    finally:
        svc.stop()


@pytest.fixture(scope="module")
def server(service):
    srv = PredictionServer(service, host="127.0.0.1", port=0)
    srv.start_background()
    yield srv
    srv.httpd.shutdown()
    srv.httpd.server_close()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _post(port, body, query=""):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict{query}", data=body, method="POST")
    return urllib.request.urlopen(req, timeout=120)


def test_healthz_names_the_device(server):
    status, payload = _get(f"http://127.0.0.1:{server.port}/healthz")
    assert status == 200
    assert payload == {"status": "ok", "backend": "cpu", "device": "cpu", "n_devices": 1}


def test_stats_endpoint(server):
    status, payload = _get(f"http://127.0.0.1:{server.port}/stats")
    assert status == 200
    assert payload["requests_total"] >= 0 and "latency_ms_p99" in payload
    assert payload["pages_in_flight"] >= 0 and payload["max_queue"] == 0


@pytest.mark.parametrize("output", ["color", "labels"])
def test_http_predict(server, service, output):
    page = make_page(7)
    with _post(server.port, encode_png(page), f"?output={output}&char_height=8") as resp:
        assert resp.status == 200 and resp.headers["Content-Type"] == "image/png"
        got = decode_image_bytes(resp.read(), as_gray=output == "labels")
    want = service.submit(page).result(timeout=120)[output]
    np.testing.assert_array_equal(got, want.astype(np.uint8))
    if output == "labels":
        assert got.shape == (64, 48) and got.max() < 3


def test_http_bad_requests(server):
    port = server.port
    for body, query in ((encode_png(make_page(0)), "?output=bogus"), (b"not a png", ""),
                        (encode_png(make_page(0)), "?char_height=abc")):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port, body, query)
        assert err.value.code == 400, query
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{port}/nope", timeout=60)
    assert err.value.code == 404


def test_http_503_on_overload(server, service):
    orig_submit = service.submit

    def rejecting(*a, **kw):
        raise ServiceOverloaded("5 pages pending (max_queue=4)")

    service.submit = rejecting
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.port, encode_png(make_page(9)))
        assert err.value.code == 503
        assert err.value.headers.get("Retry-After") == "1"
        assert "max_queue" in json.loads(err.value.read())["error"]
    finally:
        service.submit = orig_submit


def _gated(predictor):
    gate = threading.Event()
    orig = predictor.predict_dataset_fast

    def gated(dataset, batch_size=1, **kw):
        gate.wait(timeout=60)
        yield from orig(dataset, batch_size=batch_size, **kw)

    predictor.predict_dataset_fast = gated
    return gate


def test_backpressure_rejects_beyond_max_queue():
    svc = _service(max_batch=1, max_wait_ms=1.0, max_queue=2, prepare="spline")
    gate = _gated(svc.predictor)
    try:
        first = svc.submit(make_page(0))  # collected, then held at the gate
        time.sleep(0.4)
        queued = svc.submit(make_page(1))  # fills the 2-page limit
        with pytest.raises(ServiceOverloaded, match="max_queue"):
            svc.submit(make_page(3))
        assert svc.stats.rejected_total == 1
        gate.set()
        for f in (first, queued):
            assert f.result(timeout=120)["labels"].shape == (64, 48)
        assert svc.submit(make_page(4)).result(timeout=120)["labels"].size
    finally:
        gate.set()
        svc.stop()


def test_stop_fails_pending_futures():
    """stop() fails the accepted pages that have not reached the device and
    lets the batches already handed over finish; nothing hangs."""
    svc = _service(max_batch=1, max_wait_ms=1.0, prepare="spline")
    gate = _gated(svc.predictor)
    try:
        futures = [svc.submit(make_page(i)) for i in range(4)]
        time.sleep(0.3)  # page 0 at the gate, pages 1-2 handed over, page 3 waiting
        stopper = threading.Thread(target=svc.stop)
        stopper.start()
        with pytest.raises(RuntimeError, match="service stopped"):
            futures[3].result(timeout=30)
        gate.set()
        stopper.join(timeout=60)
        assert not stopper.is_alive()
        for f in futures[:3]:
            assert f.result(timeout=30)["labels"].shape == (64, 48)
        assert svc._pending_pages == 0 and svc.stats.errors_total == 1
        assert not svc._worker.is_alive() and not svc._device_worker.is_alive()
    finally:
        gate.set()


def test_serve_cli_parser():
    args = build_parser().parse_args(
        ["serve", "--load", "/tmp/model", "--port", "0", "--char_height", "8",
         "--max_batch", "4", "--max-wait-ms", "10"])
    assert args.func.__name__ == "cmd_serve"
    assert (args.max_batch, args.max_wait_ms, args.device, args.dtype) == (4, 10.0, "cuda", "bfloat16")


def test_port_agrees_with_jax_service(tmp_path):
    tree = init_params_numpy(3, seed=0)
    rng = np.random.default_rng(1)
    for leaves in tree.values():
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    save_checkpoint(str(tmp_path / "model"), {"params": tree}, {"architecture": "fcn_skip"})
    post = [find_postprocessor("cc_majority")]
    port = BatchingService(
        Predictor(PredictSettings(color_map=DEFAULT_IMAGE_MAP, n_classes=3, post_process=post),
                  network=PixelClassifier(3, model_path=str(tmp_path / "model"), device="cpu")),
        DEFAULT_IMAGE_MAP, target_line_height=6, default_char_height=16)
    jax_net = JaxClassifier(n_classes=3, compute_dtype=jnp.float32, model_path=str(tmp_path / "model"))
    from page_segmentation_tpu.inference.postprocess import find_postprocessor as jax_find

    jax = JaxService(JaxPredictor(JaxSettings(color_map=JAX_MAP, n_classes=3,
                                              post_process=[jax_find("cc_majority")]),
                                  network=jax_net),
                     JAX_MAP, target_line_height=6, default_char_height=16)
    try:
        pages = [text_page(s) for s in range(3)]
        got = [port.submit(p).result(timeout=120) for p in pages]
        want = [jax.submit(p).result(timeout=300) for p in pages]
    finally:
        port.stop()
        jax.stop()
    agree = total = 0
    for g, w in zip(got, want):
        assert g["labels"].shape == w["labels"].shape == (150, 112)
        same = g["labels"] == w["labels"]
        agree, total = agree + int(same.sum()), total + same.size
        for key in ("color", "overlay", "inverted"):
            np.testing.assert_array_equal(g[key][same], w[key][same])
    assert agree / total >= 0.9999, f"label agreement {agree / total:.6f}"
