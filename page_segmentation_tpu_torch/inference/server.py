"""Serving: a dynamic-batching HTTP prediction service.

Counterpart of ``page_segmentation_tpu/inference/server.py``:

* ``BatchingService`` collects concurrent requests for up to
  ``max_wait_ms`` (or ``max_batch`` pages) and runs them as one device
  batch.  Two threads share the work: the collector groups a batch and runs
  its host side (``ThroughputPredictor.prep_pages``: decimate, ink gather,
  upload) while the device thread dispatches, downloads and finishes the
  batch before it (``execute_batch``) and resolves its futures.  Requests
  ride the fused throughput path (``prepare="fused"``), or the per-page
  library path through ``Predictor.predict_dataset_fast`` (``"spline"``,
  and for configurations the fused path cannot express).
* ``make_handler``/``PredictionServer``: a stdlib ``ThreadingHTTPServer``
  front end.  ``POST /predict`` with an image body returns the requested
  product as a PNG; ``GET /healthz`` names the device and ``GET /stats``
  reports batch sizes and latencies.

HTTP threads only decode images and wait on futures; the two service
threads do all the device work.
"""
from __future__ import annotations

import json
import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..core.colors import ColorMap
from ..data.dataset import SingleData
from ..data.loader import DatasetLoader
from .predictor import Predictor

logger = logging.getLogger(__name__)

OUTPUTS = ("color", "overlay", "inverted", "labels")


class ServiceOverloaded(RuntimeError):
    """The service holds ``max_queue`` pages in flight; HTTP maps this to
    503 so that load balancers shed load instead of piling up latency."""


@dataclass
class ServeStats:
    """Batch-efficiency counters exposed at ``GET /stats``."""

    requests_total: int = 0
    batches_total: int = 0
    pages_total: int = 0
    errors_total: int = 0
    rejected_total: int = 0
    # bounded: only the tail feeds /stats, in a long-lived process
    batch_sizes: "deque" = field(default_factory=lambda: deque(maxlen=1024))
    latency_ms: "deque" = field(default_factory=lambda: deque(maxlen=1024))

    def snapshot(self) -> dict:
        sizes = list(self.batch_sizes)[-256:]
        lat = sorted(list(self.latency_ms)[-256:])

        def pct(p):
            return round(lat[min(int(p * len(lat)), len(lat) - 1)], 1) if lat else None

        return {
            "requests_total": self.requests_total,
            "batches_total": self.batches_total,
            "pages_total": self.pages_total,
            "errors_total": self.errors_total,
            "rejected_total": self.rejected_total,
            "mean_batch_size": round(float(np.mean(sizes)), 2) if sizes else None,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p90": pct(0.90),
            "latency_ms_p95": pct(0.95),
            "latency_ms_p99": pct(0.99),
        }


class BatchingService:
    """Collect concurrent predict requests into device batches.

    ``submit`` returns a ``Future`` that resolves to a dict of the label map
    and the color/overlay/inverted trio.  The first pending request opens a
    window of ``max_wait_ms``; what arrives inside it (up to ``max_batch``
    pages) rides the same dispatch.
    """

    def __init__(
        self,
        predictor: Predictor,
        color_map: ColorMap,
        target_line_height: int = 6,
        default_char_height: Optional[int] = None,
        max_batch: int = 16,
        max_wait_ms: float = 25.0,
        max_width: Optional[int] = None,
        max_queue: int = 0,
        resize_backend: str = "scipy",
        prepare: str = "fused",
        pipeline_depth: int = 2,
    ):
        self.predictor = predictor
        self.color_map = color_map
        self.target_line_height = target_line_height
        self.default_char_height = default_char_height
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        # backpressure: refuse new pages beyond this many in flight
        # (accepted and unresolved: queued, prepared or on the device;
        # 0 = unbounded)
        self.max_queue = max_queue
        self.max_width = max_width
        # "fused": the throughput path (host decimate, then resample,
        # normalize, forward and argmax in one device program); "spline":
        # the per-page host prepare of the library path.  Configurations the
        # fused path cannot express (max_width, high-res output,
        # post-processors other than a lone cc vote) use "spline".
        self.prepare = prepare if prepare in ("fused", "spline") else "spline"
        if self.prepare == "fused" and not self._fused_eligible():
            logger.info("fused prepare unavailable for this configuration; using the spline path")
            self.prepare = "spline"
        self._fused_predictors: Dict = {}
        self.loader = DatasetLoader(
            target_line_height, color_map, prediction=True, max_width=max_width,
            resize_backend=resize_backend,
        )
        self.stats = ServeStats()
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        # the collector prepares batch k+1 while the device thread runs batch
        # k; the bounded hand-off queue bounds the batches in flight, and
        # while it is full the collector keeps its window open
        self._prepared: "queue.Queue" = queue.Queue(maxsize=max(1, pipeline_depth))
        # pages in flight, for backpressure: the raw queue drains into the
        # pipeline long before results exist, so qsize alone under-counts
        self._pending_pages = 0
        self._pending_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="collector", daemon=True)
        self._device_worker = threading.Thread(target=self._device_run, name="device", daemon=True)
        self._worker.start()
        self._device_worker.start()

    def _fused_eligible(self) -> bool:
        from .postprocess import vote_connected_component_class

        settings = self.predictor.settings
        post = settings.post_process or []
        return (self.max_width is None and not settings.high_res_output
                and post in ([], [vote_connected_component_class]))

    # ----------------------------------------------------------- client side
    def submit(self, image: np.ndarray, binary: Optional[np.ndarray] = None,
               char_height: Optional[int] = None) -> Future:
        """Enqueue one page; resolves to {labels, color, overlay, inverted,
        data}."""
        char_height = char_height or self.default_char_height
        if not char_height:
            raise ValueError("char_height required (no service default configured)")
        if binary is None:
            # the loader's fallback: the page itself at threshold 128
            binary = np.where(image >= 128, np.uint8(255), np.uint8(0))
        future: Future = Future()
        entry = SingleData(image=np.asarray(image), binary=np.asarray(binary),
                           line_height_px=int(char_height), user_data=future)
        # claim capacity last: anything above may raise on bad input, and a
        # claim without its enqueue would leak capacity for good
        with self._pending_lock:
            if self.max_queue and self._pending_pages >= self.max_queue:
                self.stats.rejected_total += 1
                raise ServiceOverloaded(
                    f"{self._pending_pages} pages pending (max_queue={self.max_queue})")
            self._pending_pages += 1
        self.stats.requests_total += 1
        self._queue.put((time.perf_counter(), entry))
        return future

    def _pages_done(self, n: int) -> None:
        if n:
            with self._pending_lock:
                self._pending_pages -= n

    def stop(self) -> None:
        self._stop.set()
        self._queue.put(None)  # wake the collector
        self._worker.join(timeout=10)
        self._device_worker.join(timeout=10)

    # ----------------------------------------------------------- worker side
    def _collect(self) -> List:
        """Block for the first request, then hold the window open.  Once
        ``max_wait_ms`` has passed the batch closes only if a pipeline slot
        is free: while the device side is saturated, closing early buys no
        latency and costs batch size."""
        try:
            first = self._queue.get(timeout=0.25)
        except queue.Empty:
            return []
        if first is None:
            return []
        pending = [first]
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(pending) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                if not self._prepared.full():
                    break
                timeout = 0.005  # device busy: check again in small steps
            try:
                item = self._queue.get(timeout=timeout)
            except queue.Empty:
                continue
            if item is None:
                break
            pending.append(item)
        return pending

    def _fail(self, entries, exc: BaseException) -> None:
        """Fail every unresolved rider of ``entries`` and release their
        capacity."""
        self.stats.errors_total += len(entries)
        for entry in entries:
            if not entry.user_data.done():
                entry.user_data.set_exception(exc)
        self._pages_done(len(entries))

    def _run(self) -> None:
        """Collector thread: batch requests, run their host side and hand
        prepared units to the device thread."""
        while not self._stop.is_set():
            pending = self._collect()
            if not pending:
                continue
            # keyed by the future: the spline route may hand back a copy
            # of the entry (high_res_output rescales it), never another future
            t_starts = {id(e.user_data): t for t, e in pending}
            entries = [e for _, e in pending]
            try:
                units = self._prep_units(entries, t_starts)
            except Exception as exc:  # noqa: BLE001 - fail every rider
                logger.exception("batch prepare failed")
                self._fail(entries, exc)
                continue
            for index, unit in enumerate(units):
                enqueued = False
                while not self._stop.is_set():
                    try:
                        self._prepared.put(unit, timeout=0.25)
                        enqueued = True
                        break
                    except queue.Full:
                        continue
                if not enqueued:
                    # stopping with accepted work: fail its riders now, or
                    # their clients wait on futures that never resolve
                    exc = RuntimeError("service stopped before this batch ran")
                    for _, _, members, _ in units[index:]:
                        self._fail(members, exc)
                    break
        # fail what is still queued (accepted, never collected), likewise
        stop_exc = RuntimeError("service stopped before this batch ran")
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                self._fail([item[1]], stop_exc)
        self._prepared.put(None)  # release the device thread

    def _device_run(self) -> None:
        """Device thread: dispatch, download, finish, resolve futures."""
        while True:
            unit = self._prepared.get()
            if unit is None:
                return
            kind, payload, members, t_starts = unit
            try:
                if kind == "fused":
                    tp, prepared = payload
                    pred, color, overlay, inverted = tp.execute_batch(prepared)
                    done = [self._payload(entry, pred[j], color[j], overlay[j], inverted[j])
                            for j, entry in enumerate(members)]
                else:  # spline: the prepared dataset through the bucketed path
                    done = [self._payload(data, pred, color, overlay, inverted)
                            for data, pred, color, overlay, inverted in
                            self.predictor.predict_dataset_fast(payload, batch_size=self.max_batch)]
                # stats before resolution: a client that reads /stats the
                # moment its future resolves sees this batch counted
                self.stats.batches_total += 1
                self.stats.pages_total += len(done)
                self.stats.batch_sizes.append(len(done))
                for data, result in done:
                    self.stats.latency_ms.append((time.perf_counter() - t_starts[id(data.user_data)]) * 1e3)
                    data.user_data.set_result(result)
                self._pages_done(len(done))
            except Exception as exc:  # noqa: BLE001 - fail every rider
                logger.exception("batch failed")
                self._fail(members, exc)

    @staticmethod
    def _payload(data, pred, color, overlay, inverted):
        return (data, {"labels": pred, "color": color, "overlay": overlay,
                       "inverted": inverted, "data": data})

    def _prep_units(self, entries, t_starts) -> list:
        """Host stage: one collected batch -> prepared units for the device
        thread.  Fused: grayscale pages grouped by geometry through
        ``prep_pages``, color pages through the loader's spline prepare;
        spline: every page through the loader."""
        if self.prepare != "fused":
            return [("spline", self.loader.load_data(entries), entries, t_starts)]
        units = []
        color_pages = [e for e in entries if np.asarray(e.image).ndim != 2]
        if color_pages:  # a fused batch is single-plane
            units.append(("spline", self.loader.load_data(color_pages), color_pages, t_starts))
        groups: Dict = {}
        for entry in entries:
            if np.asarray(entry.image).ndim == 2:
                key = entry.image.shape[:2] + (int(entry.line_height_px),)
                groups.setdefault(key, []).append(entry)
        for key, members in groups.items():
            tp = self._fused_predictor_for(key)
            n_pad = min(self.max_batch, 1 << max(0, len(members) - 1).bit_length())
            # pad slots carry zero pixels and no ink
            prepared = tp.prep_pages([e.image for e in members], [e.binary for e in members], n_pad)
            units.append(("fused", (tp, prepared), members, t_starts))
        return units

    # each cached predictor serves one (page shape, char_height); an LRU of
    # this many keeps the hot geometries of mixed traffic
    MAX_FUSED_PREDICTORS = 8

    def _fused_predictor_for(self, key):
        """The ThroughputPredictor of one (page shape, char_height)."""
        if key in self._fused_predictors:
            self._fused_predictors[key] = self._fused_predictors.pop(key)
        else:
            while len(self._fused_predictors) >= self.MAX_FUSED_PREDICTORS:
                evicted = next(iter(self._fused_predictors))
                del self._fused_predictors[evicted]
                logger.info("evicted fused predictor for geometry %s", evicted)
            from .corpus import pick_host_decimate
            from .pipeline import ThroughputPredictor
            from .postprocess import vote_connected_component_class

            h, w, char_height = key
            scale = self.target_line_height / char_height
            net = self.predictor.network
            arch = net.architecture
            post = self.predictor.settings.post_process or []
            # the module already holds the network's weights: no state dict
            self._fused_predictors[key] = ThroughputPredictor(
                net.module,
                None,
                self.color_map.palette,
                (h, w),
                scale,
                host_decimate=pick_host_decimate(scale),
                stride_factor=arch.stride_factor,
                compute_dtype=net.compute_dtype,
                download="packed" if net.n_classes <= 4 else "pred",
                cc_vote="host" if post == [vote_connected_component_class] else False,
                preprocess_mode=arch.preprocess_mode,
                int8=self.predictor.settings.int8,
                yield_pred=True,
                device=net.device,
            )
        return self._fused_predictors[key]


def _png_bytes(arr: np.ndarray) -> bytes:
    from ..core.image_io import encode_png

    return encode_png(np.ascontiguousarray(arr))


def _device_info(device: torch.device) -> dict:
    """The backend, the card's name (or "cpu") and the device count."""
    if device.type == "cuda":
        return {"backend": "cuda", "device": torch.cuda.get_device_name(device),
                "n_devices": torch.cuda.device_count()}
    return {"backend": "cpu", "device": "cpu", "n_devices": 1}


def make_handler(service: BatchingService, request_timeout_s: float = 120.0):
    class PredictionHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # to logging, not stderr
            logger.debug("%s - %s", self.address_string(), fmt % args)

        def _json(self, code: int, payload: dict, headers=()) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 - http.server API
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {"status": "ok",
                                 **_device_info(service.predictor.network.device)})
            elif path == "/stats":
                snapshot = service.stats.snapshot()
                snapshot["queue_depth"] = service._queue.qsize()
                snapshot["pages_in_flight"] = service._pending_pages
                snapshot["max_queue"] = service.max_queue
                self._json(200, snapshot)
            else:
                self._json(404, {"error": f"unknown path {path}"})

        def do_POST(self):  # noqa: N802 - http.server API
            parsed = urlparse(self.path)
            if parsed.path != "/predict":
                self._json(404, {"error": f"unknown path {parsed.path}"})
                return
            params = {k: v[-1] for k, v in parse_qs(parsed.query).items()}
            output = params.get("output", "color")
            if output not in OUTPUTS:
                self._json(400, {"error": f"output must be one of {OUTPUTS}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._json(400, {"error": "empty body (send the page image)"})
                return
            body = self.rfile.read(length)
            try:
                from ..core.image_io import decode_image_bytes

                image = decode_image_bytes(body, as_gray=True)
            except Exception:  # noqa: BLE001 - any undecodable body is the client's
                self._json(400, {"error": "body is not a decodable image"})
                return
            try:
                char_height = params.get("char_height")
                future = service.submit(image, char_height=int(char_height) if char_height else None)
            except ServiceOverloaded as exc:
                self._json(503, {"error": str(exc)}, headers=[("Retry-After", "1")])
                return
            except ValueError as exc:
                self._json(400, {"error": str(exc)})
                return
            try:
                result = future.result(timeout=request_timeout_s)
            except Exception as exc:  # noqa: BLE001 - surface batch errors
                self._json(500, {"error": f"prediction failed: {exc}"})
                return
            arr = result[output]
            if output == "labels":
                arr = arr.astype(np.uint8)
            png = _png_bytes(arr)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(png)))
            self.end_headers()
            self.wfile.write(png)

    return PredictionHandler


class PredictionServer:
    """A ``BatchingService`` behind a ``ThreadingHTTPServer``."""

    def __init__(self, service: BatchingService, host: str = "127.0.0.1", port: int = 0):
        self.service = service
        self.httpd = ThreadingHTTPServer((host, port), make_handler(service))
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start_background(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever, name="http", daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        logger.info("serving on %s:%d", *self.httpd.server_address[:2])
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread:
            self._thread.join(timeout=10)
        self.service.stop()
