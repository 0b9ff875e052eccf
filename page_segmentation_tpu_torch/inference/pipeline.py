"""Fused device predict program + throughput executor (torch/CUDA).

Counterpart of ``page_segmentation_tpu/inference/pipeline.py``.  The host
box-decimates each full-resolution page and gathers the ink mask at the
normalized scale (native C); the device resamples (bicubic, antialiased),
inverts/normalizes, pads to the bucket, runs the net, takes the argmax,
optionally votes each ink component's majority class (CUDA labeler), and
packs the class map for the download; the host builds the
color/overlay/inverted trio.

``ThroughputPredictor.run`` overlaps three stages: a prefetch thread preps
batch i+1 and uploads it from pinned memory on a side stream, the calling
thread dispatches batch i, and a downloader thread waits for batch i-1's
device-to-host copy and builds its trio.

``int8=True`` (the grayscale FCNs) runs the int8 twin of the module
(``models/quant.py``); the first dispatched batch calibrates it with one
float32 forward of the calibrate twin (``make_fused_calibrate``), whose
ranges then stay.

With a ``mesh`` the batch pads with zero pages to a multiple of the mesh's
``data`` axis and one chunk goes up to each device, through that device's
own ``DeviceTransfers``; each device runs the whole fused program on its
chunk with its copy of the module (``parallel/mesh.py`` ``replicas_of``),
the CUDA labeler included, and its download starts on its own stream; the
padding pages are dropped after the download.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.pad import round_up
from ..train.profiling import count, span


def nearest_index_array(out_dim: int, in_dim: int) -> np.ndarray:
    coords = (np.arange(out_dim) + 0.5) * (in_dim / out_dim) - 0.5
    return np.clip(np.floor(coords + 0.5).astype(np.int64), 0, in_dim - 1)


def _device_normalize(out_h: int, out_w: int, pad_h: int, pad_w: int,
                      preprocess_mode: str = "gray"):
    """The fused program's preprocessing: cubic resample to the normalized
    shape, invert + normalize, zero-pad to the bucket.  (N, hd, wd) uint8 ->
    (N, C, pad_h, pad_w) float32.

    ``preprocess_mode='gray'`` is invert + /255 fused (C = 1).  The RGB
    encoder modes invert to ``255 - img`` (the prepared-page convention:
    ink bright), repeat it to 3 channels and apply the family's Keras
    ``preprocess_input`` twin ('caffe' ResNet50, 'tf' MobileNetV2, 'torch'
    EfficientNet); the zero pad comes after it, as in the JAX program.

    ``jax.image.resize(method="cubic")`` is Keys cubic (a = -0.5) with
    antialiasing; ``F.interpolate(mode="bicubic", antialias=True)`` is the
    torch resampler that matches it (without antialias it is off by tens of
    gray levels when downsampling)."""
    pre = None
    if preprocess_mode != "gray":
        from ..models.registry import _make_preprocess

        pre = _make_preprocess(preprocess_mode, device=True)

    def normalize(pages_u8):
        img = pages_u8.to(torch.float32)[:, None]
        img = F.interpolate(img, size=(out_h, out_w), mode="bicubic",
                            antialias=True, align_corners=False)
        if pre is None:
            img = 1.0 - img / 255.0
        else:  # NHWC for the channel-last preprocess, then back
            img = pre((255.0 - img).permute(0, 2, 3, 1).expand(-1, -1, -1, 3)).permute(0, 3, 1, 2)
        return F.pad(img, (0, pad_w - out_w, 0, pad_h - out_h))

    return normalize


def make_fused_calibrate(calibrate_module, normalized_shape: Tuple[int, int],
                         stride_factor: int = 8, bucket_granularity: int = 1):
    """fn(pages_u8 (N, hd, wd)) -> the ``amax`` collection: the fused
    program's normalization, then one float32 forward of the int8
    calibrate twin recording each layer's input range."""
    from ..models.quant import calibrate

    out_h, out_w = normalized_shape
    pad_h = round_up(out_h, stride_factor * bucket_granularity)
    pad_w = round_up(out_w, stride_factor * bucket_granularity)
    normalize = _device_normalize(out_h, out_w, pad_h, pad_w)

    def fn(pages_u8):
        with torch.no_grad():
            img = normalize(pages_u8)
        return calibrate(calibrate_module, [img.permute(0, 2, 3, 1)])

    return fn


def make_fused_predict(
    module,
    normalized_shape: Tuple[int, int],
    stride_factor: int = 8,
    bucket_granularity: int = 1,
    compute_dtype=torch.bfloat16,
    download: str = "color",
    cc_vote=False,
    mesh=None,
    data_axis: str = "data",
    preprocess_mode: str = "gray",
    device="cuda",
):
    """fn(pages_u8 (N, hd, wd), palette[, ink_packed]) on ``device``:
    resample to ``normalized_shape``, invert/normalize, pad to the bucket,
    forward, argmax.  ``download='color'`` returns the palette-gathered RGB
    mask (N, pad_h, pad_w, 3) uint8; ``'pred'`` the class map (N, pad_h,
    pad_w) uint8; ``'packed'`` 2-bit classes (N, pad_h, pad_w // 4) uint8.

    ``cc_vote`` ("xla", "pallas" or True = "xla") adds the cc-majority vote
    on the device: the fn then takes the 1-bit-packed ink mask (N, pad_h,
    pad_w // 8) and the CUDA labeler + histogram vote run before the
    download.  Both names route to the same kernel.  The module's own
    weights are used; it is moved to ``device`` and put in eval mode.

    ``mesh`` runs the program data-parallel over its ``data_axis``: the fn
    then takes and returns lists of per-device chunks (the module moves to
    the axis's first device; every other device runs its copy)."""
    if download not in ("color", "pred", "packed"):
        raise ValueError(f"download must be 'color', 'pred' or 'packed', got {download!r}")
    cc_vote = "xla" if cc_vote is True else cc_vote
    if cc_vote not in (False, None, "xla", "pallas"):
        raise ValueError(f"cc_vote must be False, True, 'xla' or 'pallas', got {cc_vote!r}")
    dev = mesh.axis_devices(data_axis)[0] if mesh is not None else resolve_device(device)
    out_h, out_w = normalized_shape
    pad_h = round_up(out_h, stride_factor * bucket_granularity)
    pad_w = round_up(out_w, stride_factor * bucket_granularity)
    normalize = _device_normalize(out_h, out_w, pad_h, pad_w, preprocess_mode)
    module.to(dev).eval()

    def core(net, pages_u8, palette, ink_packed=None):
        img = normalize(pages_u8)
        with span("ps.forward"):
            logits = net.forward_nchw(img.to(compute_dtype))
        pred = logits.argmax(dim=1)
        if cc_vote:
            from ..ops.cuda_cc import cc_vote_batch
            from .output import unpack_bits_device

            ink = unpack_bits_device(ink_packed)
            pred = cc_vote_batch(pred, ink, n_classes=logits.shape[1], device=pred.device)
        if download == "packed":
            # 2 bits/class, 4 pixels/byte (valid while n_classes <= 4)
            from .output import pack_classes_device

            return pack_classes_device(pred)
        if download == "pred":
            return pred.to(torch.uint8)
        return palette[pred.clamp(0, palette.shape[0] - 1)]

    if mesh is None:
        @torch.inference_mode()
        def fused(pages_u8, palette, ink_packed=None):
            return core(module, pages_u8, palette, ink_packed)
    else:
        from ..parallel.mesh import replicas_of

        @torch.inference_mode()
        def fused(pages_u8, palette, ink_packed=None):
            # shards launched in turn; on several cards they overlap
            replicas = replicas_of(module)
            return [core(replicas.on(pages.device), pages, palette.to(pages.device),
                         None if ink_packed is None else ink_packed[i])
                    for i, pages in enumerate(pages_u8)]

    fused.valid_shape = (out_h, out_w)
    fused.padded_shape = (pad_h, pad_w)
    return fused


class _Staged(NamedTuple):
    """A host batch on its way to the device: the device tensor and, on the
    card, the event recorded after its copy on the upload stream."""

    tensor: torch.Tensor
    ready: Optional[torch.cuda.Event]


class DeviceTransfers:
    """The pipeline's host<->device copies on ``device``.  On the card an
    upload copies into pinned memory, then runs as a non-blocking copy on a
    side stream followed by an event; a download is a non-blocking copy into
    pinned memory on the current stream followed by an event.  On the CPU
    both hand the tensor through.  ``tools/repro_download.py`` races these
    same calls against each other."""

    def __init__(self, device):
        self.device = resolve_device(device)
        self._upload_stream = (
            torch.cuda.Stream(device=self.device) if self.device.type == "cuda" else None
        )

    def put(self, arr: np.ndarray) -> _Staged:
        """Start the upload of a host array.  PyTorch's pinned-memory cache
        keeps the pinned block out of reuse until the copy has completed."""
        host = torch.from_numpy(np.ascontiguousarray(arr))
        if self._upload_stream is None:
            return _Staged(host, None)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        with torch.cuda.stream(self._upload_stream):
            tensor = pinned.to(self.device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._upload_stream)
        return _Staged(tensor, ready)

    def take(self, staged: _Staged) -> torch.Tensor:
        """The uploaded tensor, ordered on the current stream after its copy
        (and kept from reuse by the allocator until that stream is done)."""
        if staged.ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(staged.ready)
            staged.tensor.record_stream(stream)
        return staged.tensor

    def start_download(self, out: torch.Tensor):
        """Queue the device-to-host copy of ``out`` on the current stream
        (after whatever computed it) and record an event after it."""
        if self._upload_stream is None:
            return out, None
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))
        return host, done

    @staticmethod
    def wait_download(download) -> np.ndarray:
        """The downloaded array, once the copy's event has completed."""
        host, done = download
        if done is not None:
            done.synchronize()
        return host.numpy()


class ThroughputPredictor:
    """Pipelined batch predictor for same-sized full-resolution pages.

    Produces, per page, the color/overlay/inverted uint8 RGB trio at the
    normalized scale.  ``variables`` is a state_dict for ``module`` (see
    ``models/bridge.py``) or None to keep the module's weights.
    """

    def __init__(
        self,
        module,
        variables,
        palette: np.ndarray,
        page_shape: Tuple[int, int],
        scale: float,
        host_decimate: int = 8,
        stride_factor: int = 8,
        compute_dtype=torch.bfloat16,
        download: str = "color",
        cc_vote=False,
        mesh=None,
        data_axis: str = "data",
        int8: bool = False,
        reuse_output_buffers: bool = False,
        preprocess_mode: str = "gray",
        yield_pred: bool = False,
        packed_binary: bool = False,
        device="cuda",
    ):
        if int8 and preprocess_mode != "gray":
            raise ValueError("int8 supports the grayscale FCN families only")
        self.mesh = mesh
        self.data_axis = data_axis
        # mesh: the first device of the data axis holds the module; each
        # device moves its own chunks
        self.transfers = DeviceTransfers(
            mesh.axis_devices(data_axis)[0] if mesh is not None else device)
        self.device = self.transfers.device
        self._mesh_transfers = {self.device: self.transfers}
        in_h, in_w = page_shape
        self.host_decimate = host_decimate
        # default vote placement: the native host vote inside the overlapped
        # finish stage (as in the JAX package); "xla"/"pallas" vote on the
        # device
        self.cc_vote = "host" if cc_vote is True else cc_vote
        self.n_classes = int(getattr(module, "n_classes", len(palette)))
        if self.cc_vote == "host" and download == "color":
            # the host vote rewrites the class map, so the dispatch must
            # download classes, not rendered colors
            download = "packed" if self.n_classes <= 4 else "pred"
        if download == "packed" and self.n_classes > 4:
            raise ValueError(
                f"download='packed' carries 2-bit classes (n_classes <= 4); "
                f"this model has {self.n_classes} — use 'pred' or 'color'"
            )
        # yield_pred: batches come back as (pred, color, overlay, inverted)
        self.yield_pred = bool(yield_pred)
        if yield_pred and download == "color":
            raise ValueError(
                "yield_pred needs the class map on host — use "
                "download='packed' or 'pred', not 'color'"
            )
        self.download = download
        out_h = int(np.round(in_h * scale))
        out_w = int(np.round(in_w * scale))
        self.decimated_shape = (in_h // host_decimate, in_w // host_decimate)
        # opt-in trio-buffer reuse: each batch's trio is then a view into a
        # ring of per-instance buffers, valid until the ring comes round
        self.reuse_output_buffers = bool(reuse_output_buffers)
        self._trio_bufs = None
        self._ring_len = 4  # grown by run() for deeper in-flight windows
        if variables is not None:
            module.load_state_dict(variables)
        self.int8 = bool(int8)
        self._amax = self._int8_twin = self._calibrate_fn = None
        if self.int8:
            from ..models.quant import twin_classes_for

            calibrate_twin, module = twin_classes_for(module.to(self.device))
            self._int8_twin = module
            self._calibrate_fn = make_fused_calibrate(
                calibrate_twin, (out_h, out_w), stride_factor=stride_factor)
        device_vote = self.cc_vote if self.cc_vote in ("xla", "pallas") else False
        self.fused = make_fused_predict(
            module, (out_h, out_w), stride_factor=stride_factor,
            compute_dtype=compute_dtype, download=self.download,
            cc_vote=device_vote, mesh=mesh, data_axis=data_axis,
            preprocess_mode=preprocess_mode, device=self.device,
        )
        self.palette_np = np.asarray(palette, np.uint8)
        self.palette_dev = torch.as_tensor(self.palette_np, device=self.device)
        self.row_idx = nearest_index_array(out_h, in_h)
        self.col_idx = nearest_index_array(out_w, in_w)
        # packed_binary: binaries arrive as MSB-first bit rows (N, H,
        # ceil(W/8)) and the ink gather reads bits directly
        self.packed_binary = bool(packed_binary)
        self._col_bytes = self.col_idx >> 3
        self._col_shift = (7 - (self.col_idx & 7)).astype(np.uint8)

    @property
    def amax(self):
        """The int8 twin's ranges (the JAX ``amax`` collection): None until
        the first dispatch calibrates them; setting them skips that."""
        return self._amax

    @amax.setter
    def amax(self, value):
        from ..models.bridge import amax_from_jax

        amax_from_jax(self._int8_twin, value)
        self._amax = value

    # --------------------------------------------------------- device moves
    def _transfers_on(self, device) -> DeviceTransfers:
        if device not in self._mesh_transfers:
            self._mesh_transfers[device] = DeviceTransfers(device)
        return self._mesh_transfers[device]

    def _put(self, arr: np.ndarray):
        """Start the upload of a host batch; with a mesh it pads to a
        multiple of the data axis (zero pages, dropped in _finish) and each
        device's chunk goes up through its own transfers."""
        if self.mesh is None:
            return self.transfers.put(arr)
        from ..parallel.mesh import shard_batch

        devices = self.mesh.axis_devices(self.data_axis)
        pad = (-arr.shape[0]) % len(devices)
        if pad:
            arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
        return shard_batch(self.mesh, {"x": arr}, self.data_axis,
                           put=lambda piece, d: self._transfers_on(d).put(piece))["x"]

    def _take(self, staged):
        if isinstance(staged, list):
            return [self._transfers_on(s.tensor.device).take(s) for s in staged]
        return self.transfers.take(staged)

    def _start_download(self, out):
        if isinstance(out, list):
            return [self._transfers_on(o.device).start_download(o) for o in out]
        return self.transfers.start_download(out)

    def _wait_download(self, download) -> np.ndarray:
        if isinstance(download, list):
            return np.concatenate([DeviceTransfers.wait_download(d) for d in download])
        return DeviceTransfers.wait_download(download)

    # ------------------------------------------------------------ host steps
    def _gather_ink_bits(self, packed: np.ndarray) -> np.ndarray:
        """Ink mask from bit-packed binaries (N, H, ceil(W/8)): ink = bit 0
        (PNG black), sampled at the nearest grid."""
        rows = packed[:, self.row_idx, :]
        window = rows[:, :, self._col_bytes]
        return ((window >> self._col_shift) & 1) == 0

    def _prep(self, pages: np.ndarray, binaries: np.ndarray):
        """Decimate pages (box mean) + nearest-gather the ink mask."""
        from .. import native

        with span("ps.decimate"):
            dec, threads = native.decimate_u8(pages, self.host_decimate, with_threads=True)
            count("ps.decimate_bytes", pages.nbytes)
            count("ps.decimate_threads", threads)
        if self.packed_binary:
            return self._put(dec), self._gather_ink_bits(binaries)
        ink = native.gather_ink(binaries, self.row_idx, self.col_idx)
        return self._put(dec), ink.astype(bool)

    def _out_bufs(self, n: int, h: int, w: int):
        """Ring of trio buffers sized to the in-flight window (depth + the
        consumer's held batch + one being finished)."""
        if not self.reuse_output_buffers:
            return None
        shape = (n, h, w, 3)
        size = self._ring_len
        if (
            self._trio_bufs is None
            or self._trio_bufs[0][0][0].shape != shape
            or len(self._trio_bufs[0]) < size
        ):
            ring = []
            for _ in range(size):
                color = np.empty(shape, np.uint8)
                ring.append((color, np.empty_like(color), np.empty_like(color)))
            self._trio_bufs = (ring, [0])
        ring, idx = self._trio_bufs
        trio = ring[idx[0] % len(ring)]
        idx[0] += 1
        return trio

    def _host_vote(self, pred: np.ndarray, ink: np.ndarray) -> np.ndarray:
        """Per-page cc-majority vote on the host (native C union-find)."""
        from .. import native

        out = np.empty_like(pred)
        for i in range(pred.shape[0]):
            out[i] = native.cc_vote(ink[i], pred[i], self.n_classes).astype(pred.dtype)
        return out

    def _finish(self, downloaded: np.ndarray, ink: np.ndarray):
        from .. import native
        from .output import finish_mask_trio, unpack_classes

        downloaded = downloaded[: ink.shape[0]]  # drop the mesh's padding pages
        h, w = ink.shape[1:]
        if self.download == "packed":
            if self.yield_pred:
                pred = unpack_classes(downloaded)[:, :h, :w]
                if self.cc_vote == "host":
                    pred = self._host_vote(pred, ink)
                trio = finish_mask_trio(
                    pred, ink, self.palette_np, out=self._out_bufs(ink.shape[0], h, w))
                return (pred,) + trio
            # ONE ring slot per batch
            out = self._out_bufs(ink.shape[0], h, w)
            if self.cc_vote == "host":
                return native.vote_finish_packed(
                    downloaded, ink.astype(np.uint8), self.palette_np,
                    self.n_classes, out=out,
                )
            return native.finish_masks_packed(downloaded, ink, self.palette_np, out=out)
        if self.download == "pred":
            pred = downloaded[:, :h, :w]
            if self.cc_vote == "host":
                pred = self._host_vote(pred, ink)
            trio = finish_mask_trio(
                pred, ink, self.palette_np, out=self._out_bufs(ink.shape[0], h, w))
            return ((pred,) + trio) if self.yield_pred else trio
        color = downloaded[:, :h, :w]
        not_ink3 = (~ink[..., None]).astype(np.uint8)
        ink3 = ink[..., None].astype(np.uint8)
        return color, color * not_ink3, color * ink3

    def _pack_ink(self, ink: np.ndarray) -> np.ndarray:
        """1-bit pack the ink mask at the padded device shape (the vote runs
        on the padded shape with no ink in the pad)."""
        pad_h, pad_w = self.fused.padded_shape
        m, h, w = ink.shape
        padded = np.zeros((m, pad_h, pad_w), bool)
        padded[:, :h, :w] = ink
        return np.packbits(padded, axis=-1)

    def _dispatch(self, prepared, unit: Optional[int] = None) -> torch.Tensor:
        """Launch one prepared batch; ``unit`` labels its spans."""
        with span("ps.launch", unit):
            dec, _, ink_staged = prepared
            take = self._take
            pages = take(dec)
            if self._calibrate_fn is not None and self._amax is None:
                whole = (torch.cat([p.to(self.device) for p in pages])
                         if isinstance(pages, list) else pages)
                self.amax = self._calibrate_fn(whole)
            if ink_staged is not None:
                return self.fused(pages, self.palette_dev, take(ink_staged))
            return self.fused(pages, self.palette_dev)

    def _download_finish(self, download, ink: np.ndarray, unit: Optional[int] = None):
        """Wait for the copy's event, then build the host trio; runs on the
        downloader thread in run().  ``unit`` labels its spans."""
        with span("ps.finish", unit):
            with span("ps.wait_download"):
                downloaded = self._wait_download(download)
            with span("ps.trio"):
                return self._finish(downloaded, ink)

    # -------------------------------------------------------------- pipeline
    # run() pipelines a whole corpus internally; a serving engine pipelines
    # across requests instead, with these staged calls.
    def prep_batch(self, pages: np.ndarray, binaries: np.ndarray, unit: Optional[int] = None):
        """Stage 1, host + upload: decimate, start the upload, gather ink.
        Returns an opaque prepared unit for execute_batch; safe to call from
        another thread than execute_batch.  ``unit`` labels its spans."""
        with span("ps.prep", unit):
            vote = self.cc_vote in ("xla", "pallas")
            dec, ink = self._prep(pages, binaries)
            ink_staged = self._put(self._pack_ink(ink)) if vote else None
            return dec, ink, ink_staged

    def prep_pages(self, pages, binaries, n_pad: int):
        """prep_batch for a LIST of per-request full-res pages, padded to
        ``n_pad`` slots (pad slots: zero pixels, no ink)."""
        from .. import native

        vote = self.cc_vote in ("xla", "pallas")
        dec = np.zeros((n_pad,) + self.decimated_shape, np.uint8)
        oh, ow = len(self.row_idx), len(self.col_idx)
        ink = np.zeros((n_pad, oh, ow), bool)
        for i, (page, binary) in enumerate(zip(pages, binaries)):
            dec[i] = native.decimate_u8(page[None], self.host_decimate)[0]
            if self.packed_binary:
                ink[i] = self._gather_ink_bits(binary[None])[0]
            else:
                ink[i] = native.gather_ink(binary[None], self.row_idx, self.col_idx)[0]
        ink_staged = self._put(self._pack_ink(ink)) if vote else None
        return self._put(dec), ink, ink_staged

    def execute_batch(self, prepared):
        """Stage 2, device + finish: dispatch, download, host vote/trio.
        Returns what one run() iteration would yield."""
        out = self._dispatch(prepared)
        return self._download_finish(self._start_download(out), prepared[1])

    def run(self, pages: np.ndarray, binaries: np.ndarray, batch_size: int = 16,
            depth: int = 2):
        """Yield (color, overlay, inverted) batches, in order.

        A prefetch thread preps and uploads batch i+1, the calling thread
        dispatches batch i, and a downloader thread finishes batch i-1.
        ``depth`` bounds the dispatched batches awaiting their finish.

        The JAX package runs the ``cc_vote="pallas"`` case fully serialized
        because its TPU runtime corrupted the download of a Pallas-bearing
        program under concurrent device traffic.  ``tools/repro_download.py``
        checks that pattern on the card with this class's own transfers
        (side-stream pinned uploads racing an event-fenced download of the
        CUDA labeler's vote) and finds no corrupt download, so every vote
        placement keeps the overlap here (the outputs are the same).

        With the span recorder on (``train/profiling.py``), each stage's
        spans carry the batch index as their unit."""
        self._ring_len = max(4, max(depth, 1) + 2)
        n = pages.shape[0]
        starts = list(range(0, n, batch_size))
        if not starts:
            return

        def prep(index):
            start = starts[index]
            stop = min(start + batch_size, n)
            return self.prep_batch(pages[start:stop], binaries[start:stop], index)

        with ThreadPoolExecutor(max_workers=1) as prefetch, \
                ThreadPoolExecutor(max_workers=1) as downloader:
            next_prep = prefetch.submit(prep, 0)
            pending = deque()  # ordered futures of finished batches
            for index in range(len(starts)):
                with span("ps.wait_prep", index):
                    prepared = next_prep.result()
                if index + 1 < len(starts):
                    next_prep = prefetch.submit(prep, index + 1)
                download = self._start_download(self._dispatch(prepared, index))
                pending.append(
                    downloader.submit(self._download_finish, download, prepared[1], index)
                )
                while len(pending) > max(depth, 1):
                    yield pending.popleft().result()
            while pending:
                yield pending.popleft().result()
