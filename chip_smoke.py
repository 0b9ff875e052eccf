#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (page_segmentation_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels and host library from the sources in this
checkout, holds every kernel against its plain PyTorch version on the card
(the labeler also on tile-edge, checkerboard, ruled and ragged ink), times
each one from the host, on the card alone (CUDA graph) and per pass
(torch.profiler), and the host cost of each piece of the launch path,
checks the bf16 forward against float32, and drives these paths, each with
the kernels' launch counts set to 0 just before it and read just after:

* the throughput predictor over synthetic 300-DPI A4 pages with the device
  cc-majority vote on the CUDA labeler;
* the download-race tool (``tools/repro_download.py``) in both modes, which
  must see no corrupt download in either arm;
* the per-page library path: DatasetLoader -> PixelClassifier -> Predictor
  ``predict_dataset_fast`` with the device vote, the trio written as PNGs;
* the user entry points over a corpus of A4 PNGs and a checkpoint written by
  the port: the CLI's ``predict --pipeline`` (host vote) beside
  ``RawCorpusPredictor(cc_vote="pallas")``, and ``predict --fast`` (device
  vote);
* the ground-truth and segmentation tools: ``gen-masks`` over PageXML of A4
  layouts (all 5 settings, masks held against the layout), and
  ``page-segmentation --text_contours`` over the predicted PNGs and over
  full-resolution A4 label PNGs, on the host and on the card, whose files
  must be byte-equal;
* the single-card predict options over the corpus checkpoint: the
  throughput cell with ``int8=True`` (its int8 logits held against the CPU's
  bit for bit) and with the space-to-depth stem, ``Predictor(band_rows=...)``
  on a 6016x4096 page against the whole-page forward (peak device memory of
  each), and the CLI's ``export --platforms cuda`` run by ``AotClassifier``;
* the HTTP service: ``PredictionServer`` over ``BatchingService`` on
  localhost, its fused route under concurrent clients and its spline route
  (device vote);
* the training path: A4 pages with color masks written as PNGs, the CLI's
  ``create-dataset-file`` and ``train`` (3 epochs at batch 8), steady train
  steps timed on the card, one float32 step held against the CPU, and an
  epoch with device augmentation;
* the other model families (UNet, ResUNet, ResNet50, MobileNetV2,
  EfficientNet-B0 and -B7 U-Nets) at their published widths on the
  throughput path with the device vote, each held against the CPU and
  bf16 against float32, and mobile_net from a checkpoint on the library
  batch path;
* flax's fresh weights (``phase_init``): ``PixelClassifier(3, arch,
  seed=0)`` of all 14 architectures drawn on the host, every leaf held
  against the JAX package's digests (``tests/flax_init_digests.json``) and
  its copy on the card, EfficientNet-B7's draw within INIT_DRAW_LIMIT_S,
  and one throughput batch of mobile_net and effb0 from those weights with
  the device vote held against the plain labeler's;
* the Trainer on mobile_net (BatchNorm) and unet (dropout) from their fresh
  weights, with one float32 BatchNorm step held against the CPU;
* several devices, on a mesh of this card twice (``phase_mesh``): the
  throughput cell with ``mesh=`` (K1 on every shard; trio byte-equal to no
  mesh), ``spatial_forward`` of a 6016x4096 page in two bands with halos
  against the whole page, ``ParallelPredictor``, data-parallel train steps
  against the single-device step (FCNSkip) and the CPU mesh (mobile_net),
  and ``Trainer(distributed=True)`` over an NCCL group of one process with
  the step-versioned checkpoints, then its ``auto_resume``;
* training quality (``phase_quality``): the port's
  ``tools/train_quality.py`` on the 11-page golden corpus, a model trained
  on the card from a random start and evaluated on two held-out pages, with
  floors on its FgPA and per-label F1, and its bf16 labels held against its
  float32 labels on every held-out pixel.

Each phase runs under PyTorch's default cuDNN and TF32 flags (those the
port's CLI keeps) unless it states its own, prints them, and restores the
flags it found on exit.  Then it checks what comes out.  Prints one line per phase, then a JSON line
of per-kernel measurements, and as the last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when there is no card, when the package is missing, or when any phase
fails.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

A4 = (3508, 2480)          # 300-DPI A4 page
SCALE = 6 / 50             # normalize 50 px text lines to 6 px
HOST_DECIMATE = 8
BATCH = 48
N_PAGES = 96
LARGE_PAGE = (6016, 4096)  # a page above the TPU's single-block size
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
TIMING_REPS = 10
LIBRARY_PAGES = 20         # the per-page path: 2 full batches and a tail of 4
LIBRARY_BATCH = 8
LINE_HEIGHT = 50           # px per text line of the synthetic pages
REPRO_TRIALS = 20
FAST_PAGES = 20            # predict --fast: 2 full batches and a tail of 4
SERVE_PAGES = 64
SERVE_CLIENTS = 8
SERVE_BATCH = 16
SPLINE_PAGES = 16          # one batch of the spline serve route
TRAIN_PAGES = 40           # the training phase: 32 train + 8 test pages
TRAIN_BATCH = 8
TRAIN_EPOCHS = 3
STEADY_STEPS = 50


# the families' phases: published widths, A4 pages as the main path
FAMILIES = ("unet", "res_unet", "image_res_net", "mobile_net", "effb0", "effb7")
CALIBRATION_PAGES = 8      # BatchNorm statistics calibrated on one batch
CHECK_PAGES = 2            # card vs CPU forward
DECISIVE = 0.05            # bf16 gate: top-2 margin >= 5 % of the largest |logit|
TRAIN_FAMILIES = ("mobile_net", "unet")
FAMILY_EPOCHS = 2
FAMILY_LR = 1e-4           # Adam; UNet without BatchNorm diverges at 1e-3 from a random start
FAMILY_STEADY_STEPS = 20
SEG_XML_PAGES = 40         # gen-masks: PageXML of 40 A4 layouts, all 5 settings
SEG_FULL_PAGES = 16        # page-segmentation over full-resolution A4 label PNGs
SEG_BATCH = 8              # --seg_batch: pages per device morphology chain
SEG_REPS = 5
BAND_ROWS = 1024           # Predictor(band_rows=...) on the LARGE_PAGE
EXPORT_PAGES = 4           # AotClassifier batch, plus one ragged page
MESH_SHARDS = 2            # phase_mesh: shards of a mesh of the one card
MESH_RAGGED = 47           # a ragged batch after the throughput cell's pages
MESH_EXECUTOR_PAGES = 8    # ParallelPredictor batch
MESH_STEP_PAGES = 7        # FCNSkip data-parallel step: odd, one shard padded
MESH_BN_PAGES = 3          # mobile_net data-parallel step, card vs CPU
INIT_THROUGHPUT = ("mobile_net", "effb0")  # phase_init: one throughput batch each
INIT_DRAW_LIMIT_S = 5.0    # effb7's fresh draw on the host
QUALITY_EPOCHS = 300       # the recipe's cap; the trainer's early stopping ends the run
QUALITY_SPLIT = (10, ["page10", "page4"])  # the JAX tool's seed and eval pages
QUALITY_LOSS_DROP = 5
QUALITY_FGPA = 0.85
QUALITY_F1 = 0.5
QUALITY_BF16_AGREEMENT = 0.999
DEVICE = "cuda"

# the cuDNN and TF32 flags, at PyTorch's defaults: the port's CLI sets none
DEFAULT_FLAGS = {"cudnn.deterministic": False, "cudnn.benchmark": False,
                 "cudnn.allow_tf32": True, "cuda.matmul.allow_tf32": False}
NO_TF32 = {"cudnn.allow_tf32": False, "cuda.matmul.allow_tf32": False}


def log(msg: str):
    print(msg, flush=True)


def _flag_owner(name: str):
    owner = torch.backends
    *path, attr = name.split(".")
    for part in path:
        owner = getattr(owner, part)
    return owner, attr


def current_flags() -> dict:
    return {name: getattr(*_flag_owner(name)) for name in DEFAULT_FLAGS}


@contextlib.contextmanager
def backend_flags(phase: str, overrides=None):
    """Run a phase (as a ``with`` block or a decorator) under PyTorch's
    default cuDNN and TF32 flags with ``overrides`` on top, printed on a line
    of their own; the flags found on entry come back on exit, also when the
    phase fails, so no phase runs under another's settings."""
    saved = current_flags()
    try:
        for name, value in {**DEFAULT_FLAGS, **(overrides or {})}.items():
            setattr(*_flag_owner(name), value)
        log(f"flags {phase}: {json.dumps(current_flags())}")
        yield
    finally:
        for name, value in saved.items():
            setattr(*_flag_owner(name), value)


# ------------------------------------------------------------------- inputs
def synthesize_pages(n: int, h: int, w: int, seed: int, rules: bool = False):
    """Synthetic 300-DPI historical pages: 50 px text lines of glyph blocks
    (shades 10-60 on paper 235) and, on every third page, a figure block;
    with ``rules``, page-spanning horizontal and vertical rules join the
    lines into one long component.  Returns (pages, binaries) uint8, binary
    0 on ink and 255 on paper."""
    rng = np.random.default_rng(seed)
    line_height = 50
    pages = np.full((n, h, w), 235, np.uint8)
    binaries = np.full((n, h, w), 255, np.uint8)
    row_starts = np.arange(h // 8, h - h // 8 - line_height, int(line_height * 1.6))
    col_starts = np.arange(w // 10, w - w // 10 - 25, 35)
    for i in range(n):
        page, binary = pages[i], binaries[i]
        present = rng.random((len(row_starts), len(col_starts))) < 0.85
        shades = rng.integers(10, 60, size=present.shape).astype(np.uint8)
        for ri, row in enumerate(row_starts):
            for c, shade in zip(col_starts[present[ri]], shades[ri][present[ri]]):
                page[row : row + line_height, c : c + 25] = shade
                binary[row : row + line_height, c : c + 25] = 0
        if i % 3 == 0:
            fig = (slice(int(h * 0.7), int(h * 0.85)), slice(int(w * 0.2), int(w * 0.8)))
            page[fig] = 120
            binary[fig] = 0
        if rules:
            for y in range(h // 16, h, h // 8):
                page[y : y + 3] = 20
                binary[y : y + 3] = 0
            for x in (w // 20, w - w // 20):
                page[:, x : x + 3] = 20
                binary[:, x : x + 3] = 0
    return pages, binaries


def snake(h: int, w: int) -> np.ndarray:
    ink = np.zeros((h, w), np.uint8)
    for row in range(0, h, 2):
        ink[row] = 1
        if row + 1 < h:
            ink[row + 1, -1 if (row // 2) % 2 == 0 else 0] = 1
    return ink


def spiral(h: int, w: int) -> np.ndarray:
    ink = np.zeros((h, w), np.uint8)
    top, bottom, left, right = 0, h - 1, 0, w - 1
    while top < bottom and left < right:
        ink[top, left : right + 1] = 1
        ink[top : bottom + 1, right] = 1
        ink[bottom, left : right + 1] = 1
        ink[top : bottom + 1, left] = 1
        top += 4; bottom -= 4; left += 4; right -= 4
    return ink


def edge_lines(h: int, w: int, axis: int, spine: bool) -> np.ndarray:
    """1-px lines on both sides of every 32-px tile edge of the labeler,
    vertical (``axis`` 1) or horizontal (0); with ``spine`` the first row
    or column joins them into one comb."""
    ink = np.zeros((h, w), np.uint8)
    at = [i for i in range((h, w)[axis]) if i % 32 in (0, 31)]
    if axis == 1:
        ink[:, at] = 1
        ink[0] = spine
    else:
        ink[at] = 1
        ink[:, 0] = spine
    return ink


def checkerboard(h: int, w: int) -> np.ndarray:
    """No two ink pixels 4-adjacent: every pixel its own component."""
    return (np.add.outer(np.arange(h), np.arange(w)) % 2).astype(np.uint8)


def ruled(ink: np.ndarray, every: int = 20) -> np.ndarray:
    """``ink`` with 1-px rules every ``every`` rows and columns: one
    component that crosses every tile."""
    ink = ink.copy()
    ink[::every] = 1
    ink[:, ::every] = 1
    return ink


def scipy_min_labels(ink: np.ndarray) -> np.ndarray:
    """Independent oracle: scipy's 4-connected labeling, relabeled to
    1 + the minimum flat index of each component."""
    from scipy import ndimage

    labels, n = ndimage.label(ink)
    flat = np.arange(ink.size, dtype=np.int64).reshape(ink.shape)
    mins = np.zeros(n + 1, np.int64)
    mins[1:] = ndimage.minimum(flat, labels, np.arange(1, n + 1))
    return np.where(labels > 0, mins[labels] + 1, 0).astype(np.int32)


# ------------------------------------------------------------------ timing
def cuda_ms(fn, reps: int = TIMING_REPS, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` calls, each bracketed by
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cuda_ms_per_call(fns, calls: int = 200, rounds: int = 7):
    """{name: milliseconds per call} of each function of ``fns``: ``calls``
    back-to-back calls between two CUDA events, for kernels shorter than one
    launch (so the host's cost sets the time).  The functions are timed in
    turns, the order reversed every round, and each one's median over
    ``rounds`` is kept: a drift in the shared host's speed falls on all of
    them alike."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for r in range(rounds):
        for name, fn in (list(fns.items()) if r % 2 == 0 else list(fns.items())[::-1]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end) / calls)
    return {name: float(np.median(t)) for name, t in times.items()}


def graph_ms_per_call(fn, calls: int = 200, reps: int = 5) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed between two CUDA events, median over ``reps``
    replays.  The host's launch cost stays out of the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, before capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def host_us(fn, calls: int = 10_000) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` back-to-back
    calls (perf_counter, no synchronisation inside the loop)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def kernel_ms_by_name(fn, names, calls: int = 20):
    """Device milliseconds per call of ``fn`` in each kernel whose name
    holds one of ``names``, from torch.profiler over ``calls`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    totals = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for name in names:
                if name in e.name:
                    totals[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {name: ms / calls for name, ms in totals.items()}


def normalized_shapes():
    """(out_h, out_w) of a normalized A4 page and its padded (pad_h, pad_w)."""
    out_h, out_w = int(round(A4[0] * SCALE)), int(round(A4[1] * SCALE))
    return (out_h, out_w), (-(-out_h // 8) * 8, -(-out_w // 8) * 8)


def label_bound_ms(n_pixels: int) -> float:
    """Least time for the labeling: read 1 B of ink and write 4 B of label
    per pixel at the device memory rate (it does no tensor-core work)."""
    return n_pixels * (1 + 4) / HBM_BYTES_PER_S * 1e3


# ------------------------------------------------------------------ phases
@backend_flags("card")
def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"phase card: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from page_segmentation_tpu_torch import native
    from page_segmentation_tpu_torch._kernels import KERNELS, build_libraries

    t0 = time.perf_counter()
    logs = build_libraries([*KERNELS.values(), native.NATIVE_SPEC])
    build_s = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"phase build: {len(logs)} libraries built in {build_s:.2f} s (parallel compilers)")


CC_PASSES = ("tile_kernel", "border_kernel", "flatten_kernel")  # csrc/cc_label.cu


@backend_flags("kernels")
def phase_kernels(text_ink: np.ndarray, large_ink: np.ndarray):
    """Every kernel entry point against the plain PyTorch labeler on the
    card, exact equality, on random, text-like, tile-edge, checkerboard,
    ruled and ragged ink; timings at the main path's shape and at
    LARGE_PAGE: from the host (``ms``), the kernels alone in a CUDA graph
    (``device_ms``) and per pass (torch.profiler)."""
    from page_segmentation_tpu_torch.ops import cuda_cc

    dev = torch.device(DEVICE)
    max_err = 0

    def hold(name, got, want):
        nonlocal max_err
        err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{name}: kernel labels differ from the plain version (max |d| {err})")
        max_err = max(max_err, err)
        log(f"  {name}: kernel == plain, {tuple(got.shape)}, {int((got > 0).sum())} ink px")

    h, w = text_ink.shape[1:]
    rng = np.random.default_rng(SEED)
    cases = {
        "batch random ink 0.45": (rng.random(text_ink.shape) < 0.45),
        "batch text-like ink": text_ink,
        "snake/spiral/empty/full": np.stack([snake(h, w), spiral(h, w),
                                             np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]),
        "vertical lines on tile edges, comb/apart": np.stack([edge_lines(h, w, 1, True),
                                                              edge_lines(h, w, 1, False)]),
        "horizontal lines on tile edges, comb/apart": np.stack([edge_lines(h, w, 0, True),
                                                                edge_lines(h, w, 0, False)]),
        "checkerboard": checkerboard(h, w)[None],
        "rules page, one component across every tile": ruled(text_ink[0])[None],
        "ragged 421x298 unpadded": np.ascontiguousarray(text_ink[:4, :421, :298]) | (rng.random((4, 421, 298)) < 0.2),
        "ragged 1x4096": rng.random((2, 1, 4096)) < 0.7,
        "ragged 4096x1": rng.random((2, 4096, 1)) < 0.7,
        "width 300, not a multiple of 16": rng.random((3, h, 300)) < 0.5,
    }
    for name, ink in cases.items():
        ink_dev = torch.from_numpy(ink.astype(bool)).to(dev)
        got, _ = cuda_cc.cc_min_label_batch(ink_dev, device=dev)
        want, _ = cuda_cc.cc_min_label_reference(ink_dev)
        torch.cuda.synchronize()
        hold(f"cc_min_label_batch[{name}]", got, want)
    page_dev = torch.from_numpy(text_ink[0].astype(bool)).to(dev)
    got, _ = cuda_cc.cc_min_label_pallas(page_dev, device=dev)
    hold("cc_min_label_pallas[one page]", got, cuda_cc.cc_min_label_reference(page_dev[None])[0][0])
    uint8_dev = torch.from_numpy(text_ink * np.uint8(255)).to(dev)  # uint8 goes in as it is
    hold("_label_cuda[uint8 0/255 batch]", cuda_cc._label_cuda(uint8_dev),
         cuda_cc.cc_min_label_reference(uint8_dev)[0])

    large_dev = torch.from_numpy(large_ink.astype(bool)).to(dev)
    got, _ = cuda_cc.cc_min_label_tiled(large_dev, device=dev)
    plain, cycles = cuda_cc.cc_min_label_reference(large_dev[None])
    hold(f"cc_min_label_tiled[{LARGE_PAGE[0]}x{LARGE_PAGE[1]}]", got, plain[0])
    oracle = torch.from_numpy(scipy_min_labels(large_ink))
    if not torch.equal(got.cpu(), oracle):
        raise AssertionError("cc_min_label_tiled differs from scipy.ndimage.label")
    log(f"  cc_min_label_tiled == scipy.ndimage.label relabeled to min flat index "
        f"(plain version took {cycles} scan cycles)")

    def timings(ink_dev, entry, graph_calls):
        return {
            "ms": cuda_ms(entry),
            "device_ms": graph_ms_per_call(lambda: cuda_cc._label_cuda(ink_dev), calls=graph_calls),
            "pass_ms": kernel_ms_by_name(lambda: cuda_cc._label_cuda(ink_dev), CC_PASSES),
            "plain_ms": cuda_ms(lambda: cuda_cc.cc_min_label_reference(ink_dev), reps=3, warmup=1),
            "bound_ms": label_bound_ms(ink_dev.numel()),
            # the same bytes as the tile pass (1 B read, 4 B written per pixel)
            # moved by a PyTorch cast: a yardstick for it, not the function
            "cast_ms": graph_ms_per_call(lambda: ink_dev.to(torch.int32), calls=graph_calls),
        }

    main_dev = torch.from_numpy(text_ink.astype(bool)).to(dev)
    main = timings(main_dev, lambda: cuda_cc.cc_min_label_batch(main_dev, device=dev), 50)
    tiled = dict(timings(large_dev[None], lambda: cuda_cc.cc_min_label_tiled(large_dev, device=dev), 20),
                 shape=list(LARGE_PAGE))
    for where, t in ((tuple(main_dev.shape), main), (LARGE_PAGE, tiled)):
        log(f"phase kernels: cc_label at {where}: from the host {t['ms']:.4f} ms, kernels alone "
            f"(CUDA graph) {t['device_ms']:.4f} ms = "
            + " + ".join(f"{k.split('_')[0]} {v:.4f}" for k, v in t["pass_ms"].items())
            + f" ms (profiler); plain {t['plain_ms']:.3f} ms, byte bound {t['bound_ms']:.4f} ms "
            f"({t['device_ms'] / t['bound_ms']:.2f}x); ink.to(int32) in a graph {t['cast_ms']:.4f} ms")
    # the wrapper's host cost, on a page small enough that the host, not the card, sets the rate
    tiny = torch.from_numpy(text_ink[:1, :32, :32].astype(bool)).to(dev).contiguous()
    host = {"_label_cuda": host_us(lambda: cuda_cc._label_cuda(tiny), calls=2_000),
            "cc_min_label_batch": host_us(lambda: cuda_cc.cc_min_label_batch(tiny, device=dev),
                                          calls=2_000)}
    log(f"  host us per call on a 1x32x32 page over 2,000 calls: "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items()))
    return dict(main, max_abs_err=max_err, tiled=tiled, host_us=host)


@backend_flags("forward", NO_TF32)
def phase_forward(state, dec: np.ndarray):
    """FCNSkip on the card against the same module on the CPU (whose bf16
    and float32 forwards the CPU tests hold to the JAX module's), with TF32
    off so that float32 is float32: float32 logits to atol 1e-4 and argmax
    agreement >= 99.99 %, bf16 argmax agreement >= 99.9 %.  The bf16 vs
    float32 agreement on the card is reported: with random weights many
    logits are near-ties, so it measures bf16 itself, not the port."""
    from page_segmentation_tpu_torch.inference.pipeline import _device_normalize
    from page_segmentation_tpu_torch.models.fcn import FCNSkip

    (out_h, out_w), (pad_h, pad_w) = normalized_shapes()
    img = _device_normalize(out_h, out_w, pad_h, pad_w)(torch.from_numpy(dec))
    logits = {}
    for device in (DEVICE, "cpu"):
        for dtype in (torch.float32, torch.bfloat16):
            model = FCNSkip(3, dtype=dtype)
            model.load_state_dict(state)
            with torch.inference_mode():
                logits[device, dtype] = model.to(device).forward_nchw(img.to(device)).cpu()

    def agreement(a, b):
        return float((logits[a].argmax(1) == logits[b].argmax(1)).float().mean())

    f32_err = float((logits[DEVICE, torch.float32] - logits["cpu", torch.float32]).abs().max())
    f32 = agreement((DEVICE, torch.float32), ("cpu", torch.float32))
    bf16 = agreement((DEVICE, torch.bfloat16), ("cpu", torch.bfloat16))
    mixed = agreement((DEVICE, torch.bfloat16), (DEVICE, torch.float32))
    log(f"phase forward on {tuple(img.shape)}: card vs CPU float32 max |d logit| {f32_err:.2e}, "
        f"argmax agreement {f32:.6f}; bf16 agreement {bf16:.6f}; "
        f"card bf16 vs card float32 agreement {mixed:.6f} (reported)")
    if f32_err > 1e-4 or f32 < 0.9999 or bf16 < 0.999:
        raise AssertionError("the forward on the card disagrees with the CPU forward")


@backend_flags("main path")
def phase_main_path(state, pages, binaries):
    """ThroughputPredictor(cc_vote="pallas") over N_PAGES A4 pages at batch
    BATCH; checks the labeler ran and that the outputs are right."""
    from page_segmentation_tpu_torch import native
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.inference.output import finish_mask_trio
    from page_segmentation_tpu_torch.inference.pipeline import (
        ThroughputPredictor,
        make_fused_predict,
    )
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc

    palette = DEFAULT_IMAGE_MAP.palette
    module = FCNSkip(3, dtype=torch.bfloat16)

    def predictor(cc_vote):
        return ThroughputPredictor(
            module, state, palette, A4, SCALE, host_decimate=HOST_DECIMATE,
            compute_dtype=torch.bfloat16, download="packed", cc_vote=cc_vote, device=DEVICE)

    tp = predictor("pallas")
    # warm-up on one batch (cuDNN plans, library loads), outside the count
    first = tp.execute_batch(tp.prep_batch(pages[:BATCH], binaries[:BATCH]))
    torch.cuda.synchronize()

    cuda_cc.launches = cuda_add_one.launches = 0
    t0 = time.perf_counter()
    outs = [tuple(a.copy() for a in trio) for trio in tp.run(pages, binaries, batch_size=BATCH)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_cc.launches
    if cuda_add_one.launches:
        raise AssertionError("add_one ran on the throughput path")
    n_batches = -(-N_PAGES // BATCH)
    log(f"phase main path: {N_PAGES} pages at batch {BATCH} in {wall:.3f} s = "
        f"{N_PAGES / wall:.2f} pages/s; cc_label launches {launches}")
    if launches != cuda_cc.LAUNCHES_PER_CALL * n_batches:
        raise AssertionError(f"cc_label launched {launches} times, expected "
                             f"{cuda_cc.LAUNCHES_PER_CALL * n_batches}")

    out_h, out_w = tp.fused.valid_shape
    for trio in outs:
        for arr in trio:
            if arr.shape != (BATCH, out_h, out_w, 3) or arr.dtype != np.uint8:
                raise AssertionError(f"trio array {arr.shape} {arr.dtype}")
    for got, want in zip(outs[0], first):
        if not np.array_equal(got, want):
            raise AssertionError("run() and execute_batch() disagree on batch 0")

    # the device vote == the host union-find vote on the card's unvoted labels
    dev = tp.device
    dec, ink = tp._prep(pages[:BATCH], binaries[:BATCH])
    dec = tp.transfers.take(dec)
    ink_packed = torch.from_numpy(tp._pack_ink(ink)).to(dev)
    palette_dev = tp.palette_dev
    plain = make_fused_predict(module, (out_h, out_w), download="pred", device=dev)
    voted = make_fused_predict(module, (out_h, out_w), download="pred", cc_vote="pallas", device=dev)
    unvoted = plain(dec, palette_dev).cpu().numpy()
    device_voted = voted(dec, palette_dev, ink_packed).cpu().numpy()
    ink_padded = np.zeros(unvoted.shape, np.uint8)
    ink_padded[:, :out_h, :out_w] = ink
    changed = 0
    for i in range(BATCH):
        host = native.cc_vote(ink_padded[i], unvoted[i], 3)
        if not np.array_equal(host, device_voted[i]):
            raise AssertionError(f"page {i}: device vote != host ps_cc_vote")
        changed += int((host != unvoted[i]).sum())
    for got, want in zip(outs[0], finish_mask_trio(device_voted, ink, palette)):
        if not np.array_equal(got, want):
            raise AssertionError("run() trio != trio of the checked device-voted labels")
    log(f"  device vote == host ps_cc_vote on {BATCH} pages ({changed} px relabeled by the vote); "
        f"run() trio == trio of those labels")

    # the default placement: the host vote in the finish stage
    host_trio = predictor("host").execute_batch(tp.prep_batch(pages[:BATCH], binaries[:BATCH]))
    for got, want in zip(host_trio, outs[0]):
        if not np.array_equal(got, want):
            raise AssertionError('cc_vote="host" trio != cc_vote="pallas" trio')
    log('  cc_vote="host" runs on the card and gives the same trio')

    # per-stage times on one batch
    t0 = time.perf_counter()
    prepared = tp.prep_batch(pages[:BATCH], binaries[:BATCH])
    torch.cuda.synchronize()
    prep_ms = (time.perf_counter() - t0) * 1e3
    dec_t, ink_t = tp.transfers.take(prepared[0]), tp.transfers.take(prepared[2])
    device_ms = cuda_ms(lambda: tp.fused(dec_t, palette_dev, ink_t), reps=5, warmup=1)
    downloaded = tp.fused(dec_t, palette_dev, ink_t).cpu().numpy()
    t0 = time.perf_counter()
    tp._finish(downloaded, prepared[1])
    finish_ms = (time.perf_counter() - t0) * 1e3
    log(f"  stages per batch of {BATCH}: host prep+upload {prep_ms:.1f} ms, device program "
        f"{device_ms:.3f} ms, host finish {finish_ms:.1f} ms")
    return launches, tp


def launch_pieces_us(x: torch.Tensor):
    """Host microseconds per call of each piece of the kernel launch path,
    over 10,000 calls each: the pieces of the wrapper before this redesign
    (``old:``), those of ``_kernels.launch`` (``new:``), and whole calls."""
    import ctypes
    import threading

    from page_segmentation_tpu_torch import _kernels
    from page_segmentation_tpu_torch.device import on_card, resolve_device
    from page_segmentation_tpu_torch.ops import cuda_add_one

    dev, index = x.device, x.get_device()
    entry = cuda_add_one._ADD_ONE
    fn = entry.fn or entry.bind()
    out = torch.empty_like(x)
    n, xp, op = x.numel(), x.data_ptr(), out.data_ptr()
    stream = _kernels.current_raw_stream(index)
    lock = threading.Lock()
    count = [0]

    def locked():  # the wrappers count their launches under a lock
        with lock:
            count[0] += 1

    def unlocked():
        count[0] += 1

    def guard():
        with torch.cuda.device(dev):
            pass

    pieces = {
        "old: resolve_device (torch.cuda.is_available)": lambda: resolve_device(dev),
        "old: x.to(int32).contiguous()": lambda: x.to(torch.int32).contiguous(),
        "old: load_library (lock + dict)": lambda: _kernels.load_library(_kernels.KERNELS["add_one"]),
        "old: with torch.cuda.device": guard,
        "old: torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "old: 3 ctypes.c_void_p": lambda: (ctypes.c_void_p(xp), ctypes.c_void_p(op), ctypes.c_void_p(stream)),
        "old: ctypes call with c_void_p args (launch)": lambda: fn(
            ctypes.c_void_p(xp), ctypes.c_void_p(op), n, ctypes.c_void_p(stream)),
        "new: on_card": lambda: on_card(x, dev),
        "new: x.get_device()": x.get_device,
        "new: dtype + contiguity check": lambda: x.dtype != torch.int32 or not x.is_contiguous(),
        "new: torch.empty_like": lambda: torch.empty_like(x),
        "new: entry.fn": lambda: entry.fn,
        "new: torch._C._cuda_getDevice": torch._C._cuda_getDevice,
        "new: current_raw_stream": lambda: _kernels.current_raw_stream(index),
        "new: bound ctypes call (launch)": lambda: fn(xp, op, n, stream),
        "new: _kernels.launch": lambda: _kernels.launch(entry, index, xp, op, n),
        "locked counter": locked,
        "unlocked counter": unlocked,
        "whole: _add_one_cuda": lambda: cuda_add_one._add_one_cuda(x),
        "whole: add_one": lambda: cuda_add_one.add_one(x, device=dev),
        "whole: torch.add(x, 1)": lambda: torch.add(x, 1),
        "empty loop": lambda: None,
    }
    return {name: host_us(piece) for name, piece in pieces.items()}


@backend_flags("repro_download")
def phase_repro_download():
    """K3's kernel against its plain version at the tool's shape, timed
    beside torch.add; then the download-race tool in both modes, on the
    card, with no corrupt download allowed in any arm."""
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.tools import repro_download

    dev = torch.device(DEVICE)
    x = torch.from_numpy(repro_download.trial_input(np.random.RandomState(SEED))).to(dev)
    x = x.to(torch.int32)
    got, want = cuda_add_one.add_one(x, device=dev), cuda_add_one.add_one_reference(x)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max())
    if got.shape != want.shape or got.dtype != torch.int32 or err != 0:
        raise AssertionError(f"add_one differs from its plain version (max |d| {err})")
    per_call = cuda_ms_per_call({"ms": lambda: cuda_add_one.add_one(x, device=dev),
                                 "plain_ms": lambda: cuda_add_one.add_one_reference(x),
                                 "library_ms": lambda: torch.add(x, 1)})
    kernel = {
        "shape": list(x.shape),
        "max_abs_err": err,
        **per_call,
        # 4 B read and 4 B written per element
        "bound_ms": x.numel() * 8 / HBM_BYTES_PER_S * 1e3,
        "graph_ms": graph_ms_per_call(lambda: cuda_add_one.add_one(x, device=dev)),
        "plain_graph_ms": graph_ms_per_call(lambda: cuda_add_one.add_one_reference(x)),
        "library_graph_ms": graph_ms_per_call(lambda: torch.add(x, 1)),
    }
    log(f"phase repro_download: add_one == plain at {tuple(x.shape)}; per call over 200 "
        f"back-to-back launches (median of 7 rounds in turns): kernel {kernel['ms']:.5f} ms, plain {kernel['plain_ms']:.5f} ms, "
        f"torch.add {kernel['library_ms']:.5f} ms; device time per call in a CUDA graph of 200: "
        f"kernel {kernel['graph_ms']:.5f} ms, plain {kernel['plain_graph_ms']:.5f} ms, "
        f"torch.add {kernel['library_graph_ms']:.5f} ms; byte bound {kernel['bound_ms']:.6f} ms")
    kernel["host_us"] = launch_pieces_us(x)
    log("  host us per call over 10,000 calls: " + ", ".join(
        f"{k} {v:.3f}" for k, v in kernel["host_us"].items()))

    launches = {}
    for simple in (True, False):
        mode = "simple" if simple else "real"
        cuda_add_one.launches = cuda_cc.launches = 0
        failures = repro_download.run(trials=REPRO_TRIALS, simple=simple, device=dev)
        torch.cuda.synchronize()
        launches[mode] = {"add_one": cuda_add_one.launches, "cc_label": cuda_cc.launches}
        if any(failures.values()):
            raise AssertionError(f"repro_download {mode} mode: corrupt downloads {failures}")
    want_launches = {"simple": {"add_one": REPRO_TRIALS, "cc_label": 0},
                     "real": {"add_one": 0, "cc_label": cuda_cc.LAUNCHES_PER_CALL * REPRO_TRIALS}}
    if launches != want_launches:
        raise AssertionError(f"repro_download launches {launches}, expected {want_launches}")
    log(f"  repro_download: 0 corrupt downloads in {REPRO_TRIALS} trials x 2 arms x 2 modes; "
        f"launches {launches}")
    kernel["launches"] = launches["simple"]["add_one"]
    kernel["cc_label_launches"] = launches["real"]["cc_label"]
    return kernel


def _pngs_decode_to(out_dir: str, name: str, arrays):
    """The trio PNGs of one page decode, through zlib alone, to ``arrays``."""
    import os

    from page_segmentation_tpu_torch.core.image_io import decode_png_unfiltered

    for category, want in zip(("color", "overlay", "inverted"), arrays):
        with open(os.path.join(out_dir, category, name), "rb") as f:
            decoded = decode_png_unfiltered(f.read())
        if decoded is None:
            raise AssertionError(f"{category}/{name} is not a filter-0 PNG")
        pixels, palette = decoded
        if palette is not None:
            pixels = palette[pixels]
        if not np.array_equal(pixels, want):
            raise AssertionError(f"{category}/{name} does not decode to the yielded array")


# two dispatches of the same batch must give the same labels
@backend_flags("library", {"cudnn.deterministic": True, **NO_TF32})
def phase_library(pages, binaries):
    """The per-page library path at the full width of FCNSkip (3 classes,
    weights init_params_numpy(3, SEED)) on LIBRARY_PAGES A4 pages: load,
    predict_dataset_fast in bf16 with the device vote and the trio written,
    then hold every product against the host's."""
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.data.dataset import SingleData
    from page_segmentation_tpu_torch.data.loader import DatasetLoader
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.postprocess import (
        cc_vote_on_device,
        vote_connected_component_class,
    )
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.ops.pad import pad_to

    palette = DEFAULT_IMAGE_MAP.palette

    t0 = time.perf_counter()
    loader = DatasetLoader(target_line_height=6, color_map=DEFAULT_IMAGE_MAP, prediction=True)
    dataset = loader.load_data([
        SingleData(image=pages[i], binary=binaries[i], line_height_px=LINE_HEIGHT,
                   output_path=f"page{i:02d}.png") for i in range(LIBRARY_PAGES)])
    loader_s = time.perf_counter() - t0
    shapes = {d.image.shape for d in dataset}
    log(f"phase library: DatasetLoader prepared {LIBRARY_PAGES} A4 pages to {shapes} in "
        f"{loader_s:.3f} s")
    if shapes != {normalized_shapes()[0]}:
        raise AssertionError(f"prepared shapes {shapes}")

    bf16 = PixelClassifier(3, compute_dtype=torch.bfloat16, seed=SEED, device=DEVICE)
    f32 = PixelClassifier(3, seed=SEED, device=DEVICE)
    bucket = normalized_shapes()[1]

    def batch(start):
        chunk = dataset.data[start : start + LIBRARY_BATCH]
        images = np.zeros((LIBRARY_BATCH,) + bucket, np.uint8)
        bins = np.zeros_like(images)
        for i, d in enumerate(chunk):
            images[i], bins[i] = pad_to(d.image, bucket), pad_to(d.binary, bucket)
        return chunk, images, bins

    _, images0, bins0 = batch(0)
    bf16.predict_batch_masks(images0, bins0, palette, device_vote=True)  # warm-up, not counted
    torch.cuda.synchronize()

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_trio_")
    settings = PredictSettings(n_classes=3, output=out_dir, color_map=DEFAULT_IMAGE_MAP,
                               post_process=[vote_connected_component_class])
    cuda_cc.launches = cuda_add_one.launches = 0
    t0 = time.perf_counter()
    results = list(Predictor(settings, network=bf16).predict_dataset_fast(
        dataset, batch_size=LIBRARY_BATCH, write_output=True))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = cuda_cc.launches
    n_batches = -(-LIBRARY_PAGES // LIBRARY_BATCH)
    log(f"  predict_dataset_fast: {LIBRARY_PAGES} pages at batch {LIBRARY_BATCH} (device vote, "
        f"trio written) in {wall:.3f} s = {LIBRARY_PAGES / wall:.2f} pages/s; "
        f"cc_label launches {launches}")
    if launches != cuda_cc.LAUNCHES_PER_CALL * n_batches or cuda_add_one.launches:
        raise AssertionError(f"cc_label launched {launches} times (expected "
                             f"{cuda_cc.LAUNCHES_PER_CALL * n_batches}), add_one {cuda_add_one.launches}")
    if len(results) != LIBRARY_PAGES:
        raise AssertionError(f"{len(results)} results for {LIBRARY_PAGES} pages")

    # the device vote == the host vote on the same dispatch's unvoted labels
    changed = 0
    for start in range(0, LIBRARY_PAGES, LIBRARY_BATCH):
        chunk, images, bins = batch(start)
        unvoted, _ = bf16.predict_batch_masks(images, bins, palette)
        for i, d in enumerate(chunk):
            h, w = d.image.shape
            host = vote_connected_component_class(unvoted[i], SingleData(binary=bins[i]))[:h, :w]
            data, pred, *trio = results[start + i]
            if pred.shape != (h, w) or not np.array_equal(pred, host):
                raise AssertionError(f"{d.output_path}: device vote != host vote of the unvoted labels")
            changed += int((host != unvoted[i, :h, :w]).sum())
            _pngs_decode_to(out_dir, d.output_path, trio)
    shutil.rmtree(out_dir)
    log(f"  device vote == host vote of the same dispatch's unvoted labels on {LIBRARY_PAGES} "
        f"pages ({changed} px relabeled); the trio PNGs decode through zlib to the yielded arrays")

    # the single-page path, and the fast path without the vote
    plain = PredictSettings(n_classes=3, color_map=DEFAULT_IMAGE_MAP)
    single32, single16 = Predictor(plain, network=f32), Predictor(plain, network=bf16)
    single32.predict_single(dataset.data[0])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    labels32 = [single32.predict_single(d).labels for d in dataset]
    single_ms = (time.perf_counter() - t0) * 1e3 / LIBRARY_PAGES
    labels16 = [single16.predict_single(d).labels for d in dataset]
    fast16 = [r[1] for r in Predictor(plain, network=bf16).predict_dataset_fast(dataset, LIBRARY_BATCH)]
    fast32 = [r[1] for r in Predictor(plain, network=f32).predict_dataset_fast(dataset, LIBRARY_BATCH)]

    def agreement(a, b):
        return float(np.mean([np.mean(x == y) for x, y in zip(a, b)]))

    same32, same16, mixed = agreement(fast32, labels32), agreement(fast16, labels16), agreement(fast16, labels32)
    log(f"  predict_single float32: {single_ms:.3f} ms/page; fast vs single argmax agreement "
        f"float32 {same32:.6f}, bf16 {same16:.6f}; bf16 fast vs float32 single {mixed:.6f} (reported)")
    if same32 < 0.999 or same16 < 0.999:
        raise AssertionError("the fast path disagrees with the single-page path")

    # cc_vote_on_device on the prepared pages == the host vote
    for d, pred in zip(dataset, labels32):
        got = cc_vote_on_device(pred, d.binary, 3, device=DEVICE).cpu().numpy()
        if not np.array_equal(got, vote_connected_component_class(pred, SingleData(binary=d.binary))):
            raise AssertionError(f"{d.output_path}: cc_vote_on_device != host vote")
    log(f"  cc_vote_on_device == host vote on {LIBRARY_PAGES} prepared pages")

    # device time of one batch's dispatch (upload excluded)
    x = torch.from_numpy(images0).to(DEVICE)
    ink = torch.from_numpy(np.packbits(bins0 != 0, axis=-1)).to(DEVICE)
    device_ms = cuda_ms(lambda: bf16.masks_device(x, ink, pack=True), reps=5, warmup=1)
    log(f"  device program per batch of {LIBRARY_BATCH} at {bucket}: {device_ms:.3f} ms "
        f"(normalize, bf16 FCNSkip, argmax, cc vote, 2-bit pack)")
    return {"launches": launches, "pages_per_s": LIBRARY_PAGES / wall, "loader_s": loader_s,
            "single_ms": single_ms, "device_ms": device_ms}


def _write_corpus(root: str, pages, binaries):
    """The pages as 8-bit gray PNGs under ``root``/images and their binaries
    as 1-bit PNGs (the corpus's packed-binary layout) under ``root``/binary,
    written by the port in parallel; returns the file names."""
    import os

    from page_segmentation_tpu_torch.core.image_io import imsave, imsave_bilevel
    from page_segmentation_tpu_torch.data.dataset import io_pool

    names = [f"page{i:03d}.png" for i in range(len(pages))]
    for sub in ("images", "binary"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def write(i):
        imsave(os.path.join(root, "images", names[i]), pages[i])
        imsave_bilevel(os.path.join(root, "binary", names[i]), binaries[i])

    list(io_pool().map(write, range(len(pages))))
    return names


# two runs over the same files must give the same labels
@backend_flags("corpus", {"cudnn.deterministic": True})
def phase_corpus(pages, binaries, work: str):
    """The CLI and the raw-corpus streamer over N_PAGES A4 PNGs with a
    checkpoint the port writes (FCNSkip, 3 classes, init_params_numpy(3,
    SEED), run in bf16): ``predict --pipeline --post_process cc_majority``
    (host vote) timed with its PNG writes, ``RawCorpusPredictor(cc_vote=
    "pallas")`` whose trio must equal the CLI's PNGs, and ``predict --fast
    --post_process cc_majority`` (device vote) over FAST_PAGES pages, held
    against ``Predictor.predict_dataset_fast``."""
    import os

    from page_segmentation_tpu_torch.cli.main import main as cli
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.core.image_io import imsave
    from page_segmentation_tpu_torch.data.dataset import SingleData
    from page_segmentation_tpu_torch.data.loader import DatasetLoader
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.corpus import RawCorpusPredictor, RawPage
    from page_segmentation_tpu_torch.inference.postprocess import vote_connected_component_class
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.models.bridge import init_params_numpy
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    model = os.path.join(work, "model")
    t0 = time.perf_counter()
    save_checkpoint(model, {"params": init_params_numpy(3, SEED)}, {"architecture": "fcn_skip", "n_classes": 3})
    names = _write_corpus(work, pages, binaries)
    log(f"phase corpus: checkpoint and {len(names)} A4 pages (8-bit PNG images, 1-bit PNG binaries) "
        f"written in {time.perf_counter() - t0:.2f} s")
    common = ["--load", model, "--char_height", str(LINE_HEIGHT), "--dtype", "bfloat16", "--device", DEVICE]
    images_dir, binary_dir = os.path.join(work, "images"), os.path.join(work, "binary")
    out = os.path.join(work, "pipeline_out")

    def counted(fn):
        """(seconds, cc_label launches) of one run, counts set to 0 just before."""
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        seconds, launches = time.perf_counter() - t0, cuda_cc.launches
        if cuda_add_one.launches:
            raise AssertionError("add_one ran on a predict path")
        return seconds, launches, result

    cli_s, cli_launches, rc = counted(lambda: cli(
        ["predict", "--pipeline", "--post_process", "cc_majority", "--batch_size", str(BATCH),
         "--images", images_dir, "--binary", binary_dir, "--output", out] + common))
    if rc != 0 or cli_launches:
        raise AssertionError(f"predict --pipeline returned {rc}, cc_label launches {cli_launches} (host vote: 0)")
    log(f"  predict --pipeline --post_process cc_majority (host vote), CLI in-process: {len(names)} pages "
        f"at batch {BATCH} in {cli_s:.3f} s = {len(names) / cli_s:.2f} pages/s, PNG reads and trio "
        f"writes included; cc_label launches {cli_launches}")

    cls = PixelClassifier(3, compute_dtype=torch.bfloat16, model_path=model, device=DEVICE)
    runner = RawCorpusPredictor(cls, DEFAULT_IMAGE_MAP.palette, batch_size=BATCH, cc_vote="pallas",
                                compute_dtype=torch.bfloat16)
    raw = [RawPage(os.path.join(images_dir, n), os.path.join(binary_dir, n), LINE_HEIGHT) for n in names]
    pallas_s, pallas_launches, results = counted(lambda: [(p.name, trio) for p, *trio in runner.run(raw)])
    want_launches = cuda_cc.LAUNCHES_PER_CALL * -(-len(names) // BATCH)
    log(f"  RawCorpusPredictor(cc_vote='pallas'): {len(names)} pages in {pallas_s:.3f} s = "
        f"{len(names) / pallas_s:.2f} pages/s (PNG reads, no writes); cc_label launches {pallas_launches}")
    if pallas_launches != want_launches:
        raise AssertionError(f"cc_label launched {pallas_launches} times, expected {want_launches}")
    out_shape = normalized_shapes()[0] + (3,)
    for name, trio in results:
        if any(a.shape != out_shape for a in trio):
            raise AssertionError(f"{name}: trio shapes {[a.shape for a in trio]}")
        _pngs_decode_to(out, name, trio)
    log(f"  the device-voted trio == the CLI's host-voted trio PNGs on all {len(names)} pages")

    # the corpus path's stages, one after another on the same files
    stages = {}
    t0 = time.perf_counter()
    (key, members), = runner.group(raw)
    stages["header probe + group"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    images, bins = runner._load_slice(runner._SliceRing(), members, *key[:2], packed=True)
    stages["slice decode (io pool)"] = time.perf_counter() - t0
    predictor = runner._predictor_for(key, packed_binary=True)
    t0 = time.perf_counter()
    trios = [t for batch in predictor.run(images, bins, batch_size=BATCH) for t in zip(*batch)]
    torch.cuda.synchronize()
    stages["throughput run (pallas vote)"] = time.perf_counter() - t0
    written = os.path.join(work, "stage_writes")
    for sub in ("color", "overlay", "inverted"):
        os.makedirs(os.path.join(written, sub))
    t0 = time.perf_counter()
    for name, trio in zip(names, trios):
        for sub, arr in zip(("color", "overlay", "inverted"), trio):
            imsave(os.path.join(written, sub, name), arr)
    stages["trio PNG writes"] = time.perf_counter() - t0
    log(f"  corpus stages for {len(names)} pages: " + ", ".join(
        f"{k} {v * 1e3:.1f} ms" for k, v in stages.items()))

    fast_dir = os.path.join(work, "fast")
    for sub, source in (("images", images_dir), ("binary", binary_dir)):
        os.makedirs(os.path.join(fast_dir, sub))
        for n in names[:FAST_PAGES]:
            os.symlink(os.path.join(source, n), os.path.join(fast_dir, sub, n))
    fast_out = os.path.join(work, "fast_out")
    fast_s, fast_launches, rc = counted(lambda: cli(
        ["predict", "--fast", "--post_process", "cc_majority", "--batch_size", str(LIBRARY_BATCH),
         "--images", os.path.join(fast_dir, "images"), "--binary", os.path.join(fast_dir, "binary"),
         "--output", fast_out] + common))
    want_launches = cuda_cc.LAUNCHES_PER_CALL * -(-FAST_PAGES // LIBRARY_BATCH)
    log(f"  predict --fast --post_process cc_majority (device vote): {FAST_PAGES} pages at batch "
        f"{LIBRARY_BATCH} in {fast_s:.3f} s = {FAST_PAGES / fast_s:.2f} pages/s, loader and trio writes "
        f"included; cc_label launches {fast_launches}")
    if rc != 0 or fast_launches != want_launches:
        raise AssertionError(f"predict --fast returned {rc}, cc_label launches {fast_launches} "
                             f"(expected {want_launches})")
    dataset = DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=True).load_data([
        SingleData(image=pages[i], binary=binaries[i], line_height_px=LINE_HEIGHT, output_path=names[i])
        for i in range(FAST_PAGES)])
    settings = PredictSettings(n_classes=3, color_map=DEFAULT_IMAGE_MAP,
                               post_process=[vote_connected_component_class])
    for data, _pred, *trio in Predictor(settings, network=cls).predict_dataset_fast(dataset, LIBRARY_BATCH):
        _pngs_decode_to(fast_out, data.output_path, trio)
    log(f"  predict --fast trio PNGs == Predictor.predict_dataset_fast's trio on {FAST_PAGES} pages")
    return {"model": model, "cli_pages_per_s": len(names) / cli_s, "cli_launches": cli_launches,
            "pallas_pages_per_s": len(names) / pallas_s, "pallas_launches": pallas_launches,
            "fast_pages_per_s": FAST_PAGES / fast_s, "fast_launches": fast_launches,
            "stages_ms": {k: v * 1e3 for k, v in stages.items()}}


def _layout_pagexml(i: int, h: int, w: int) -> bytes:
    """PageXML of ``layout_regions(i)`` by the port's ``build_pagexml``:
    text lines as paragraph TextRegions, the figure as an ImageRegion; each
    TextRegion then gets a TextLine of its own outline with a Baseline along
    its last row, so that the line settings draw too."""
    import re

    from page_segmentation_tpu_torch.pagexml.xml_gen import build_pagexml
    from page_segmentation_tpu_torch.segmentation.xycut import RectSegment

    regions = layout_regions(i, h, w)
    rect = {cls: [RectSegment(r0, c0, r1 - 1, c1 - 1) for c, r0, r1, c0, c1 in regions if c == cls]
            for cls in (1, 2)}
    doc = build_pagexml(f"page{i:03d}.png", (h, w), rect[1], rect[2]).decode()
    lines = iter(r for r in regions if r[0] == 1)

    def add_line(m):
        _, r0, r1, c0, c1 = next(lines)
        return (f'{m.group(1)}\n      <TextLine id="l{m.group(2)}"><Coords points="{m.group(3)}"/>'
                f'<Baseline points="{c0},{r1 - 1} {c1 - 1},{r1 - 1}"/></TextLine>\n    </TextRegion>')

    doc = re.sub(r'(<TextRegion id="r(\d+)" type="paragraph">\n\s*<Coords points="([^"]*)"/>)'
                 r'\n\s*</TextRegion>', add_line, doc)
    return doc.encode()


def _expected_mask(i: int, h: int, w: int, setting: str, line_width: int = 5) -> np.ndarray:
    """The color mask ``gen-masks`` must draw for ``_layout_pagexml(i)``,
    painted here with slices: filled rectangles include both end points, a
    horizontal baseline of width 5 covers the two rows on each side."""
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP

    red, green = DEFAULT_IMAGE_MAP.palette[1], DEFAULT_IMAGE_MAP.palette[2]
    mask = np.full((h, w, 3), 255, np.uint8)
    for cls, r0, r1, c0, c1 in layout_regions(i, h, w):
        if cls == 2 and setting in ("all_types", "text_nontext"):
            mask[r0:r1, c0:c1] = green
        elif cls == 1 and setting == "baseline":
            half = (line_width - 1) // 2
            mask[r1 - 1 - half : r1 + half, c0:c1] = red
        elif cls == 1:
            mask[r0:r1, c0:c1] = red
    return mask


def _segment_stages(paths, work: str) -> dict:
    """Milliseconds a page of each stage of ``page-segmentation
    --text_contours`` at char height LINE_HEIGHT, run one after another
    through ``PageSegmenter``'s own steps: decode, text mask, the native host
    chain, the device chain's round trip (pack, upload, chain, download,
    unpack) per batch of SEG_BATCH, contours, the XY cut of the image
    label, and render + PNG + PageXML writes."""
    import os

    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.segmentation.batch import PageSegmenter
    from page_segmentation_tpu_torch.segmentation.device_morph import morph_kernels
    from page_segmentation_tpu_torch.segmentation.pc_segmentation import (
        contours_from_region_mask,
        text_region_mask,
    )

    out = os.path.join(work, "seg_stages")
    seg = PageSegmenter(DEFAULT_IMAGE_MAP, 300, True, out + "_render", xml_output_dir=out + "_xml",
                        backend="device", batch_size=SEG_BATCH, device=DEVICE)
    ms = {}

    def timed(name, fn, per=1):
        t0 = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3 / per
        return value

    loaded = [timed("decode", lambda: seg._load(p)) for p in paths]
    masks = [timed("text mask", lambda: seg._text_mask(*page[1:])) for page in loaded]
    regions = [timed("host chain", lambda: text_region_mask(m, LINE_HEIGHT)) for m in masks]
    kernels = morph_kernels(LINE_HEIGHT)
    for i in range(0, len(masks), SEG_BATCH):
        batch = np.stack(masks[i : i + SEG_BATCH])
        timed("device chain round trip", lambda: seg._device.run(batch, kernels))
    contours = [timed("contours", lambda: contours_from_region_mask(r)) for r in regions]
    for page, cont in zip(loaded, contours):
        _, images = timed("xy cut (image)", lambda: seg._segments(*page[1:], LINE_HEIGHT))
        shape = page[2].shape
        timed("render + PNG + PageXML", lambda: seg._finish_page(page[0], shape, None, images, cont))
    return {k: v / len(paths) for k, v in ms.items()}


@backend_flags("segment")
def phase_segment(work: str):
    """The ground-truth and segmentation tools: ``gen-masks`` over PageXML of
    SEG_XML_PAGES A4 layouts written by the port's ``save_pagexml`` (all 5
    settings, masks held against the painted layout), and
    ``page-segmentation --text_contours --xml_output_dir`` over the
    predicted color PNGs of ``phase_corpus`` and over SEG_FULL_PAGES
    full-resolution A4 label PNGs at char height 50, each with
    ``--morph_backend host`` and ``--morph_backend device --device cuda``,
    whose output files must be byte-equal.  Times the device chain per batch
    of SEG_BATCH A4 pages (CUDA events) beside the native host chain per
    page."""
    import glob
    import os

    from page_segmentation_tpu_torch import native
    from page_segmentation_tpu_torch.cli.main import main as cli
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.core.image_io import imread_labels, imread_rgb, imsave_indexed
    from page_segmentation_tpu_torch.data.dataset import io_pool
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.pagexml.mask_gen import MaskSetting, get_xml_regions
    from page_segmentation_tpu_torch.segmentation.device_morph import (
        morph_kernels,
        text_region_chain,
    )

    h, w = A4
    result = {"pages_per_s": {}}
    cuda_cc.launches = cuda_add_one.launches = 0
    torch.cuda.reset_peak_memory_stats()

    # gen-masks
    xml_dir = os.path.join(work, "seg_xml")
    os.makedirs(xml_dir)

    def write_xml(i):
        with open(os.path.join(xml_dir, f"page{i:03d}.xml"), "wb") as f:
            f.write(_layout_pagexml(i, h, w))

    list(io_pool().map(write_xml, range(SEG_XML_PAGES)))
    for setting in ("all_types", "text_nontext", "baseline", "textline", "text_only"):
        out = os.path.join(work, f"seg_masks_{setting}")
        t0 = time.perf_counter()
        rc = cli(["gen-masks", "--input_dir", xml_dir, "--output_dir", out, "--setting", setting,
                  "--threads", "8"])
        seconds = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"gen-masks --setting {setting} returned {rc}")
        result["pages_per_s"][f"gen_masks_{setting}"] = SEG_XML_PAGES / seconds

        def check(i):
            got = imread_rgb(os.path.join(out, f"page{i:03d}.mask.png"))
            return bool((got == _expected_mask(i, h, w, setting)).all())

        bad = [i for i, ok in enumerate(io_pool().map(check, range(SEG_XML_PAGES))) if not ok]
        if bad:
            raise AssertionError(f"gen-masks --setting {setting}: pages {bad} differ from the layout")
        log(f"  gen-masks --setting {setting}: {SEG_XML_PAGES} A4 pages in {seconds:.3f} s = "
            f"{SEG_XML_PAGES / seconds:.2f} pages/s (8 threads, PNG writes included); masks == layout")
    page = get_xml_regions(os.path.join(xml_dir, "page000.xml"), MaskSetting())
    if page.image_size != (h, w) or len(page.xml_regions) != len(layout_regions(0, h, w)):
        raise AssertionError("the PageXML does not read back as written")

    # page-segmentation: phase_corpus's predictions and full-resolution labels
    label_dir = os.path.join(work, "seg_labels")
    os.makedirs(label_dir)
    list(io_pool().map(lambda i: imsave_indexed(os.path.join(label_dir, f"page{i:03d}.png"),
                                                layout_labels(i, h, w), DEFAULT_IMAGE_MAP.palette),
                       range(SEG_FULL_PAGES)))
    runs = {"predicted": (sorted(glob.glob(os.path.join(work, "pipeline_out", "color", "*.png"))),
                          round(LINE_HEIGHT * SCALE)),
            "full_res": (sorted(glob.glob(os.path.join(label_dir, "*.png"))), LINE_HEIGHT)}
    for name, (paths, char_height) in runs.items():
        if not paths:
            raise AssertionError(f"page-segmentation {name}: no input pages")
        outs = {}
        for backend in ("host", "device"):
            out = os.path.join(work, f"seg_{name}_{backend}")
            argv = ["page-segmentation", "--prediction", *paths, "--output_dir", out + "_render",
                    "--xml_output_dir", out + "_xml", "--char_height", str(char_height),
                    "--text_contours", "--seg_batch", str(SEG_BATCH), "--morph_backend", backend]
            argv += ["--device", DEVICE] if backend == "device" else []
            t0 = time.perf_counter()
            rc = cli(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"page-segmentation {name} {backend} returned {rc}")
            result["pages_per_s"][f"{name}_{backend}"] = len(paths) / seconds
            log(f"  page-segmentation --text_contours {name} ({len(paths)} pages, char height "
                f"{char_height}) --morph_backend {backend}: {seconds:.3f} s = "
                f"{len(paths) / seconds:.2f} pages/s, PNG reads, renders and PageXML included")
            outs[backend] = out
        for sub in ("_render", "_xml"):
            files = sorted(os.listdir(outs["host"] + sub))
            if len(files) != len(paths) or files != sorted(os.listdir(outs["device"] + sub)):
                raise AssertionError(f"page-segmentation {name}: files {sub} differ in number")
            for f in files:
                with open(os.path.join(outs["host"] + sub, f), "rb") as a, \
                        open(os.path.join(outs["device"] + sub, f), "rb") as b:
                    if a.read() != b.read():
                        raise AssertionError(f"page-segmentation {name}: {sub[1:]} {f} differs "
                                             "between the host and device backends")
        log(f"  page-segmentation {name}: host and device backends wrote byte-equal renders and "
            f"PageXML for {len(paths)} pages")
    # the full-resolution regions are right: every text pixel of the layout
    # lies in a rendered text region (on the (W, H) canvas the reference's
    # text-contours render draws, clipped to it), and each page has regions
    text = np.asarray(DEFAULT_IMAGE_MAP.palette[1])
    rows, cols = min(h, w), min(w, h)
    for i in range(SEG_FULL_PAGES):
        labels, palette = imread_labels(os.path.join(work, "seg_full_res_host_render", f"page{i:03d}.png"))
        rendered = (palette[labels] == text).all(-1)
        truth = (layout_labels(i, h, w) == 1)[:rows, :cols]
        if rendered.shape != (w, h) or not rendered[:rows, :cols][truth].all():
            raise AssertionError(f"full-resolution page {i}: text regions miss text pixels")
        regions = get_xml_regions(os.path.join(work, "seg_full_res_host_xml", f"page{i:03d}.xml"),
                                  MaskSetting())
        if not regions.xml_regions:
            raise AssertionError(f"full-resolution page {i}: no regions in the PageXML")
    result["launches"] = {"cc_label": cuda_cc.launches, "add_one": cuda_add_one.launches}
    if cuda_cc.launches or cuda_add_one.launches:
        raise AssertionError(f"a kernel launched on the segmentation path: {result['launches']}")
    result["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20

    # the chain alone: device batch of SEG_BATCH A4 masks vs the native host chain
    kernels = morph_kernels(LINE_HEIGHT)
    masks = np.stack([layout_labels(i, h, w) == 1 for i in range(SEG_BATCH)])
    on_card = torch.from_numpy(masks).to(DEVICE)
    result["device_chain_ms_per_batch"] = cuda_ms(lambda: text_region_chain(on_card, kernels),
                                                  reps=SEG_REPS, warmup=1)
    host = []
    for i in range(SEG_REPS):
        t0 = time.perf_counter()
        native.bitmorph_chain(masks[i % SEG_BATCH], *kernels)
        host.append((time.perf_counter() - t0) * 1e3)
    result["host_chain_ms_per_page"] = float(np.median(host))
    got = text_region_chain(on_card, kernels).cpu().numpy()
    if not all((got[i] == (native.bitmorph_chain(masks[i], *kernels) != 0)).all() for i in range(SEG_BATCH)):
        raise AssertionError("the device chain differs from the native host chain at A4")
    result["stages_ms_per_page"] = _segment_stages(runs["full_res"][0], work)
    log("  segment stages at A4 (ms a page, one after another on the full-resolution labels): "
        + ", ".join(f"{k} {v:.2f}" for k, v in result["stages_ms_per_page"].items()))
    log(f"  text-contours chain at A4, kernels {kernels}: device {result['device_chain_ms_per_batch']:.3f} ms "
        f"per batch of {SEG_BATCH} ({result['device_chain_ms_per_batch'] / SEG_BATCH:.3f} ms/page, CUDA "
        f"events), native host chain {result['host_chain_ms_per_page']:.3f} ms/page; peak "
        f"{result['peak_mib']:.1f} MiB of device memory")
    return result


# the served labels must equal a direct run of the same batch
def _decisive(logits: torch.Tensor) -> torch.Tensor:
    """Pixels of NCHW float32 ``logits`` whose top-2 margin is at least
    DECISIVE of the largest |logit|."""
    top2 = logits.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]) >= DECISIVE * logits.abs().max()


def _in_turns(fns: dict, reps: int = 5) -> dict:
    """{name: [ms, ms]}: each function's median CUDA-event time, measured in
    the turns a, b, b, a."""
    names = list(fns)
    times = {name: [] for name in names}
    for name in names + names[::-1]:
        times[name].append(cuda_ms(fns[name], reps=reps, warmup=1))
    return times


@backend_flags("options")
def phase_options(pages, binaries, model: str, work: str):
    """The single-card predict options over the corpus checkpoint (FCNSkip,
    3 classes), each path with the kernels' launch counts set to 0 just
    before it and read just after:

    * int8: ThroughputPredictor(int8=True, cc_vote="pallas",
      download="packed") over the N_PAGES A4 pages at batch BATCH; its
      labels against the host union-find vote over the same int8 argmax;
      with the card's calibrated ranges carried to the CPU, the card's int8
      logits of CHECK_PAGES pages against the CPU int8 twin's, bit for bit;
      device ms a batch beside bf16's; calibration ms;
    * s2d: the same cell with FCNSkip(s2d_stem=True) in bf16; float32 card
      logits against the dense stem's (TF32 off), bf16 argmax against dense
      on decisive pixels; device ms of both;
    * banded: one LARGE_PAGE prepared page through Predictor(band_rows=1024)
      and through the unbanded classifier, float32 with TF32 off: logits,
      labels on decisive pixels, peak device memory and ms of each;
    * export: the CLI's ``export --platforms cuda`` -> AotClassifier on the
      card over 4 prepared pages at the bucket shape and one ragged page,
      against PixelClassifier's float32 argmax; ms a batch of each."""
    import os

    from page_segmentation_tpu_torch import native
    from page_segmentation_tpu_torch.cli.main import main as cli
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.data.dataset import SingleData
    from page_segmentation_tpu_torch.data.loader import DatasetLoader
    from page_segmentation_tpu_torch.inference.aot import AotClassifier
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.pipeline import (
        ThroughputPredictor,
        _device_normalize,
        make_fused_predict,
    )
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.models.bridge import amax_from_jax
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.models.quant import QuantFCNSkip
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.ops.pad import pad_to

    palette = DEFAULT_IMAGE_MAP.palette
    (out_h, out_w), (pad_h, pad_w) = normalized_shapes()
    n_batches = -(-N_PAGES // BATCH)
    want_launches = cuda_cc.LAUNCHES_PER_CALL * n_batches
    state = PixelClassifier(3, model_path=model, device="cpu").module.state_dict()
    report, launches = {}, {}

    def counted(name, fn):
        """Run one path with the launch counts set to 0 just before it."""
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {"cc_label": cuda_cc.launches, "add_one": cuda_add_one.launches}
        return wall, result

    def throughput(module, int8=False):
        return ThroughputPredictor(
            module, state, palette, A4, SCALE, host_decimate=HOST_DECIMATE,
            compute_dtype=torch.bfloat16, download="packed", cc_vote="pallas", int8=int8,
            yield_pred=True, device=DEVICE)

    def run_cell(tp):
        tp.execute_batch(tp.prep_batch(pages[:BATCH], binaries[:BATCH]))  # warm-up, uncounted
        torch.cuda.synchronize()
        return lambda: [b[0].copy() for b in tp.run(pages, binaries, batch_size=BATCH)]

    dense = FCNSkip(3, dtype=torch.bfloat16)
    tp16 = throughput(dense)
    dec, ink = tp16._prep(pages[:BATCH], binaries[:BATCH])
    dec = tp16.transfers.take(dec)
    ink_dev = torch.from_numpy(tp16._pack_ink(ink)).to(DEVICE)
    normalize = _device_normalize(out_h, out_w, pad_h, pad_w)
    x_check = normalize(dec[:CHECK_PAGES])  # float32, the fused program's input

    # ---- int8 throughput
    tp8 = throughput(FCNSkip(3, dtype=torch.bfloat16), int8=True)
    wall, preds = counted("int8_throughput", run_cell(tp8))
    if launches["int8_throughput"] != {"cc_label": want_launches, "add_one": 0}:
        raise AssertionError(f"int8 path launches {launches['int8_throughput']}")
    twin = tp8._int8_twin
    plain = make_fused_predict(twin, (out_h, out_w), compute_dtype=torch.bfloat16,
                               download="pred", device=DEVICE)
    unvoted = plain(dec, tp8.palette_dev).cpu().numpy()
    ink_padded = np.zeros(unvoted.shape, np.uint8)
    ink_padded[:, :out_h, :out_w] = ink
    for i in range(BATCH):
        host = native.cc_vote(ink_padded[i], unvoted[i], 3)[:out_h, :out_w]
        if not np.array_equal(host, preds[0][i]):
            raise AssertionError(f"int8 page {i}: labels != host vote over the int8 argmax")
    cpu_twin = QuantFCNSkip(3, mode="int8")
    cpu_twin.load_state_dict(state)
    amax_from_jax(cpu_twin, tp8.amax)
    x16 = x_check.to(torch.bfloat16)
    with torch.inference_mode():
        card8 = twin.forward_nchw(x16).cpu()
        cpu8 = cpu_twin.forward_nchw(x16.cpu())
    int8_err = float((card8 - cpu8).abs().max())
    if not torch.equal(card8, cpu8):
        raise AssertionError(f"card int8 logits != CPU int8 logits (max |d| {int8_err:.3e})")
    with torch.inference_mode():
        ref32 = FCNSkip(3).to(DEVICE)
        ref32.load_state_dict(state)
        with backend_flags("options: float32 reference", NO_TF32):
            logits32 = ref32.forward_nchw(x_check)
        dense.to(DEVICE).load_state_dict(state)
        pred16 = dense.forward_nchw(x16).argmax(1).cpu()
    decisive = _decisive(logits32).cpu()
    agree8 = (card8.argmax(1) == pred16)
    calibrate_ms = cuda_ms(lambda: tp8._calibrate_fn(dec), reps=3, warmup=1)
    _, busy_us, by_name, _ = profiled(lambda: tp8.fused(dec, tp8.palette_dev, ink_dev))
    top8 = {k: v / 1e3 for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]}
    ms = _in_turns({"bf16": lambda: tp16.fused(dec, tp16.palette_dev, ink_dev),
                    "int8": lambda: tp8.fused(dec, tp8.palette_dev, ink_dev)})
    report["int8"] = {
        "pages_per_s": N_PAGES / wall, "device_ms": ms["int8"], "bf16_device_ms": ms["bf16"],
        "calibrate_ms": calibrate_ms, "decisive_share": float(decisive.float().mean()),
        "agree_bf16_decisive": float(agree8[decisive].float().mean()),
        "agree_bf16_raw": float(agree8.float().mean()), "card_vs_cpu_max_abs": int8_err,
        "profiled_busy_ms": busy_us / 1e3, "top_kernels_ms": top8}
    log(f"phase options, int8: {N_PAGES} pages at batch {BATCH} in {wall:.3f} s = "
        f"{N_PAGES / wall:.2f} pages/s; device ms a batch int8 {ms['int8']} vs bf16 {ms['bf16']} "
        f"(turns bf16, int8, int8, bf16); calibration {calibrate_ms:.3f} ms; labels == host vote over "
        f"the int8 argmax on {BATCH} pages; card int8 logits == CPU int8 logits bit for bit on "
        f"{CHECK_PAGES} pages; int8 vs bf16 argmax {report['int8']['agree_bf16_decisive']:.6f} on "
        f"decisive pixels ({report['int8']['decisive_share']:.3f} of all), "
        f"{report['int8']['agree_bf16_raw']:.6f} raw; cc_label launches "
        f"{launches['int8_throughput']['cc_label']}")
    log(f"  int8 device program under torch.profiler: busy {busy_us / 1e3:.3f} ms; top kernels (ms) "
        + json.dumps({k[:60]: round(v, 3) for k, v in top8.items()}))
    if report["int8"]["agree_bf16_decisive"] < 0.9:
        raise AssertionError("int8 argmax disagrees with bf16 on decisive pixels")

    # ---- s2d throughput
    s2d = FCNSkip(3, dtype=torch.bfloat16, s2d_stem=True)
    tp_s2d = throughput(s2d)
    runs_before = s2d.s2d_runs
    wall, preds = counted("s2d_throughput", run_cell(tp_s2d))
    if launches["s2d_throughput"] != {"cc_label": want_launches, "add_one": 0}:
        raise AssertionError(f"s2d path launches {launches['s2d_throughput']}")
    if s2d.s2d_runs - runs_before != n_batches + 1:
        raise AssertionError(f"the s2d stem ran {s2d.s2d_runs - runs_before} times")
    s2d32 = FCNSkip(3, s2d_stem=True).to(DEVICE)
    s2d32.load_state_dict(state)
    with backend_flags("options: s2d float32", NO_TF32), torch.inference_mode():
        s2d_logits32 = s2d32.forward_nchw(x_check)
    with torch.inference_mode():
        s2d_pred16 = s2d.forward_nchw(x16).argmax(1).cpu()
    s2d_err = float((s2d_logits32 - logits32).abs().max() / logits32.abs().max())
    agree_s2d = s2d_pred16 == pred16
    ms = _in_turns({"dense": lambda: tp16.fused(dec, tp16.palette_dev, ink_dev),
                    "s2d": lambda: tp_s2d.fused(dec, tp_s2d.palette_dev, ink_dev)})
    report["s2d"] = {"pages_per_s": N_PAGES / wall, "device_ms": ms["s2d"],
                     "dense_device_ms": ms["dense"], "float32_rel_err": s2d_err,
                     "agree_dense_bf16_decisive": float(agree_s2d[decisive].float().mean()),
                     "agree_dense_bf16_raw": float(agree_s2d.float().mean())}
    log(f"phase options, s2d: {N_PAGES} pages at batch {BATCH} in {wall:.3f} s = "
        f"{N_PAGES / wall:.2f} pages/s; device ms a batch s2d {ms['s2d']} vs dense {ms['dense']}; "
        f"float32 s2d vs dense max |d logit| / max |logit| {s2d_err:.2e}; bf16 argmax vs dense "
        f"{report['s2d']['agree_dense_bf16_decisive']:.6f} on decisive pixels, "
        f"{report['s2d']['agree_dense_bf16_raw']:.6f} raw; cc_label launches "
        f"{launches['s2d_throughput']['cc_label']}")
    if s2d_err > 1e-4 or report["s2d"]["agree_dense_bf16_decisive"] < 0.999:
        raise AssertionError("the s2d stem disagrees with the dense stem")

    # ---- banded forward of one large prepared page
    page = 255 - synthesize_pages(1, *LARGE_PAGE, seed=SEED + 1, rules=True)[0][0]
    data = SingleData(image=page, binary=np.ones(LARGE_PAGE, np.uint8))
    net32 = PixelClassifier(3, model_path=model, device=DEVICE)
    banded = Predictor(PredictSettings(n_classes=3, band_rows=BAND_ROWS), network=net32)
    if not banded._use_banded(data):
        raise AssertionError("the large page does not take the banded route")
    stats = {}

    def measured(name, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        wall, out = counted(name, fn)
        stats[name] = {"ms": wall * 1e3,
                       "peak_mib": (torch.cuda.max_memory_allocated() - base) / 2**20}
        return out

    with backend_flags("options: banded", NO_TF32):
        for _ in range(2):  # the first round warms both shapes up
            logit_b, _, pred_b = measured("banded", lambda: banded._banded_single_data(data))
            logit_u, _, pred_u = measured("whole", lambda: net32.predict_single_data(data))
    if launches["banded"] != {"cc_label": 0, "add_one": 0}:
        raise AssertionError(f"banded path launches {launches['banded']}")
    band_err = float(np.abs(logit_b - logit_u).max() / np.abs(logit_u).max())
    top2 = np.sort(logit_u, -1)[..., -2:]
    band_decisive = top2[..., 1] - top2[..., 0] >= DECISIVE * np.abs(logit_u).max()
    same = pred_b == pred_u
    report["banded"] = {"page": list(LARGE_PAGE), "band_rows": BAND_ROWS,
                        "rel_err": band_err, "agree_decisive": float(same[band_decisive].mean()),
                        "agree_raw": float(same.mean()), **{f"{k}_{m}": v[m] for k, v in stats.items()
                                                             for m in ("ms", "peak_mib")}}
    log(f"phase options, banded: {LARGE_PAGE} page, band_rows {BAND_ROWS}: peak "
        f"{stats['banded']['peak_mib']:.1f} MiB in {stats['banded']['ms']:.1f} ms vs whole "
        f"{stats['whole']['peak_mib']:.1f} MiB in {stats['whole']['ms']:.1f} ms (host softmax "
        f"included); max |d logit| / max |logit| {band_err:.2e}; labels equal on "
        f"{report['banded']['agree_decisive']:.6f} of decisive pixels, {report['banded']['agree_raw']:.6f} "
        f"raw; cc_label launches {launches['banded']['cc_label']}")
    if band_err > 5e-4 or report["banded"]["agree_decisive"] < 1.0:
        raise AssertionError("the banded forward disagrees with the whole page's")

    # ---- the exported program
    artifact = os.path.join(work, "model.pt2z")
    t0 = time.perf_counter()
    rc = cli(["export", "--load", model, "--output", artifact, "--platforms", DEVICE])
    export_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"export returned {rc}")
    prepared = DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=True).load_data([
        SingleData(image=pages[i], binary=binaries[i], line_height_px=LINE_HEIGHT)
        for i in range(EXPORT_PAGES + 1)])
    batch = np.stack([pad_to(d.image, (pad_h, pad_w)) for d in prepared.data[:EXPORT_PAGES]])
    ragged = prepared.data[EXPORT_PAGES].image

    def export_path():
        aot = AotClassifier(artifact, device=DEVICE)
        return aot, aot.predict(batch), aot.predict(ragged)

    with backend_flags("options: export", NO_TF32):
        _, (aot, got, got_ragged) = counted("export", export_path)
        x = torch.from_numpy(batch).to(DEVICE)
        eager = net32.masks_device(x, None, pack=False).cpu().numpy()
        with torch.inference_mode():
            logits = net32.module.forward_nchw(
                net32.architecture.device_preprocess()(x.float()[..., None]).permute(0, 3, 1, 2))
        export_decisive = _decisive(logits).cpu().numpy()
        ragged_padded = np.zeros((1, pad_h, pad_w), np.uint8)
        ragged_padded[0, : ragged.shape[0], : ragged.shape[1]] = ragged
        eager_ragged = net32.masks_device(torch.from_numpy(ragged_padded).to(DEVICE), None,
                                          pack=False).cpu().numpy()[0, : ragged.shape[0], : ragged.shape[1]]
        ms = {"eager": [], "exported": []}
        for name in ("eager", "exported", "exported", "eager"):
            fn = ((lambda: net32.masks_device(torch.from_numpy(batch).to(DEVICE), None, pack=False)
                   .cpu().numpy()) if name == "eager" else (lambda: aot.predict(batch)))
            fn()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            ms[name].append(float(np.median(times)))
    if launches["export"] != {"cc_label": 0, "add_one": 0}:
        raise AssertionError(f"export path launches {launches['export']}")
    same = got == eager
    report["export"] = {"export_s": export_s, "ms_eager": ms["eager"], "ms_exported": ms["exported"],
                        "agree_decisive": float(same[export_decisive].mean()),
                        "agree_raw": float(same.mean()),
                        "ragged_agree_raw": float((got_ragged == eager_ragged).mean())}
    log(f"phase options, export: export --platforms {DEVICE} in {export_s:.2f} s "
        f"({os.path.getsize(artifact) / 2**20:.1f} MiB); AotClassifier on the card vs "
        f"PixelClassifier float32 on {EXPORT_PAGES} pages at {(pad_h, pad_w)}: labels equal on "
        f"{report['export']['agree_decisive']:.6f} of decisive pixels, {report['export']['agree_raw']:.6f} "
        f"raw; the {ragged.shape} page padded and cropped: {report['export']['ragged_agree_raw']:.6f}; "
        f"ms a batch of {EXPORT_PAGES} (host clock, upload and download included) exported "
        f"{ms['exported']} vs eager {ms['eager']}")
    if got.shape != batch.shape or got_ragged.shape != ragged.shape \
            or report["export"]["agree_decisive"] < 1.0:
        raise AssertionError("the exported program disagrees with the classifier")
    return {"report": report, "launches": launches}


@backend_flags("serve", {"cudnn.deterministic": True})
def phase_serve(pages, model: str):
    """PredictionServer over BatchingService on localhost, fused route with
    cc_majority (host vote) and max_batch SERVE_BATCH: SERVE_PAGES A4 PNGs
    posted for their labels by SERVE_CLIENTS client threads, every reply held
    against a direct ThroughputPredictor(yield_pred=True, cc_vote="host") run
    of the batch the service formed; then SPLINE_PAGES pages through the
    spline route (device vote), held against Predictor.predict_dataset_fast."""
    import hashlib
    import threading
    import urllib.request

    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.core.image_io import (
        decode_image_bytes,
        decode_png_unfiltered,
        encode_png,
    )
    from page_segmentation_tpu_torch.data.dataset import SingleData, io_pool
    from page_segmentation_tpu_torch.data.loader import DatasetLoader
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
    from page_segmentation_tpu_torch.inference.postprocess import vote_connected_component_class
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.inference.server import BatchingService, PredictionServer, ServeStats
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc

    cls = PixelClassifier(3, compute_dtype=torch.bfloat16, model_path=model, device=DEVICE)
    settings = PredictSettings(n_classes=3, color_map=DEFAULT_IMAGE_MAP,
                               post_process=[vote_connected_component_class])
    service = BatchingService(Predictor(settings, network=cls), DEFAULT_IMAGE_MAP,
                              default_char_height=LINE_HEIGHT, max_batch=SERVE_BATCH)
    if service.prepare != "fused":
        raise AssertionError(f"the service chose the {service.prepare} route")
    service.submit(pages[0]).result(timeout=300)  # warm-up: the geometry's predictor, plans
    tp = next(iter(service._fused_predictors.values()))
    formed = []  # (pages, binaries, n_pad) of every batch the service prepares
    prep_pages = tp.prep_pages

    def recording_prep_pages(batch_pages, batch_binaries, n_pad):
        formed.append((list(batch_pages), list(batch_binaries), n_pad))
        return prep_pages(batch_pages, batch_binaries, n_pad)

    tp.prep_pages = recording_prep_pages
    bodies = list(io_pool().map(encode_png, pages[:SERVE_PAGES]))
    replies, latency_ms, errors = [None] * SERVE_PAGES, [0.0] * SERVE_PAGES, []
    server = PredictionServer(service)  # 127.0.0.1, a free port
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"

    def client(k):
        for i in range(k, SERVE_PAGES, SERVE_CLIENTS):
            request = urllib.request.Request(
                f"{base}/predict?char_height={LINE_HEIGHT}&output=labels", data=bodies[i], method="POST")
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(request, timeout=300) as reply:
                    replies[i] = reply.read()
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(f"page {i}: {exc!r}")
                return
            latency_ms[i] = (time.perf_counter() - t0) * 1e3

    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as reply:
            health = json.loads(reply.read())
        service.stats = ServeStats()  # count the timed run only
        cuda_cc.launches = cuda_add_one.launches = 0
        threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        serve_s = time.perf_counter() - t0
        fused_launches = cuda_cc.launches
        with urllib.request.urlopen(base + "/stats", timeout=60) as reply:
            stats = json.loads(reply.read())
    finally:
        server.stop()
    if errors or any(t.is_alive() for t in threads) or any(r is None for r in replies):
        raise AssertionError(f"serve: {len(errors)} failed requests {errors[:3]}")
    if health.get("device") != torch.cuda.get_device_name(0):
        raise AssertionError(f"/healthz does not name the card: {health}")
    lat = np.sort(latency_ms)
    serve = {"pages_per_s": SERVE_PAGES / serve_s, "client_p50_ms": float(np.percentile(lat, 50)),
             "client_p99_ms": float(np.percentile(lat, 99)), "stats": stats,
             "fused_launches": fused_launches, "healthz": health}
    log(f"phase serve: /healthz {health}; {SERVE_PAGES} A4 PNGs posted by {SERVE_CLIENTS} clients "
        f"(fused route, cc_majority on the host, max_batch {SERVE_BATCH}) in {serve_s:.3f} s = "
        f"{serve['pages_per_s']:.2f} pages/s; client latency p50 {serve['client_p50_ms']:.1f} ms, "
        f"p99 {serve['client_p99_ms']:.1f} ms; /stats mean batch {stats['mean_batch_size']}, "
        f"p50 {stats['latency_ms_p50']} ms, p99 {stats['latency_ms_p99']} ms, batches "
        f"{stats['batches_total']}, errors {stats['errors_total']}; cc_label launches {fused_launches}")
    if fused_launches or cuda_add_one.launches or stats["errors_total"] or stats["pages_total"] != SERVE_PAGES:
        raise AssertionError(f"serve stats {stats}, cc_label launches {fused_launches}")

    reference = ThroughputPredictor(
        cls.module, None, DEFAULT_IMAGE_MAP.palette, A4, SCALE, host_decimate=HOST_DECIMATE,
        compute_dtype=torch.bfloat16, download="packed", cc_vote="host", yield_pred=True, device=DEVICE)
    want = {}
    for batch_pages, batch_binaries, n_pad in formed:
        pred = reference.execute_batch(reference.prep_pages(batch_pages, batch_binaries, n_pad))[0]
        for j, page in enumerate(batch_pages):
            want[hashlib.sha1(page).digest()] = pred[j]
    for i in range(SERVE_PAGES):
        got = decode_png_unfiltered(replies[i])
        if got is None or not np.array_equal(got[0], want[hashlib.sha1(pages[i]).digest()]):
            raise AssertionError(f"page {i}: served labels != direct ThroughputPredictor labels")
    log(f"  every served label map == a direct ThroughputPredictor(yield_pred=True, cc_vote='host') "
        f"run of its batch ({len(formed)} batches, sizes {sorted(len(f[0]) for f in formed)})")

    # the serve path's stages, one after another, at a batch of 4 pages
    stage_ms = {}
    t0 = time.perf_counter()
    decoded = [decode_image_bytes(body, as_gray=True) for body in bodies[:4]]
    stage_ms["HTTP body decode per page"] = (time.perf_counter() - t0) * 1e3 / 4
    t0 = time.perf_counter()
    batch_binaries = [np.where(p >= 128, np.uint8(255), np.uint8(0)) for p in decoded]
    stage_ms["submit's binary per page"] = (time.perf_counter() - t0) * 1e3 / 4
    t0 = time.perf_counter()
    prepared = reference.prep_pages(decoded, batch_binaries, 4)
    stage_ms["prep_pages, batch of 4"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    pred = reference.execute_batch(prepared)[0]
    torch.cuda.synchronize()
    stage_ms["execute_batch, batch of 4"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for labels in pred:
        encode_png(labels.astype(np.uint8))
    stage_ms["labels PNG encode per page"] = (time.perf_counter() - t0) * 1e3 / 4
    log("  serve stages: " + ", ".join(f"{k} {v:.1f} ms" for k, v in stage_ms.items())
        + f"; request body {np.mean([len(b) for b in bodies]) / 1e6:.2f} MB on average")

    spline = BatchingService(Predictor(settings, network=cls), DEFAULT_IMAGE_MAP,
                             default_char_height=LINE_HEIGHT, max_batch=SPLINE_PAGES,
                             max_wait_ms=10_000, prepare="spline")
    try:
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        results = [f.result(timeout=600) for f in [spline.submit(p) for p in pages[:SPLINE_PAGES]]]
        torch.cuda.synchronize()
        spline_s, spline_launches, spline_batches = time.perf_counter() - t0, cuda_cc.launches, spline.stats.batches_total
    finally:
        spline.stop()
    log(f"  spline route (host prepare, device vote): {SPLINE_PAGES} pages in {spline_batches} batch(es) "
        f"in {spline_s:.3f} s = {SPLINE_PAGES / spline_s:.2f} pages/s; cc_label launches {spline_launches}")
    if spline_batches != 1 or spline_launches != cuda_cc.LAUNCHES_PER_CALL or cuda_add_one.launches:
        raise AssertionError(f"spline route: {spline_batches} batches, cc_label launches {spline_launches}")
    dataset = DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=True).load_data([
        SingleData(image=p, binary=np.where(p >= 128, np.uint8(255), np.uint8(0)), line_height_px=LINE_HEIGHT)
        for p in pages[:SPLINE_PAGES]])
    for result, (_, pred, color, overlay, inverted) in zip(
            results, Predictor(settings, network=cls).predict_dataset_fast(dataset, SPLINE_PAGES)):
        for key, arr in (("labels", pred), ("color", color), ("overlay", overlay), ("inverted", inverted)):
            if not np.array_equal(result[key], arr):
                raise AssertionError(f"spline route {key} != Predictor.predict_dataset_fast's")
    log(f"  spline route results == Predictor.predict_dataset_fast's on {SPLINE_PAGES} pages")
    serve.update(spline_pages_per_s=SPLINE_PAGES / spline_s, spline_launches=spline_launches,
                 stages_ms=stage_ms)
    return serve


def layout_regions(i: int, h: int, w: int):
    """The regions of ``synthesize_pages``' page ``i`` as (class, row0, row1,
    col0, col1), ends exclusive: its text lines (each row of glyph blocks,
    across the text column) as text (1) and the figure block of every third
    page as image (2)."""
    line_height = 50
    col_starts = np.arange(w // 10, w - w // 10 - 25, 35)
    regions = [(1, row, row + line_height, col_starts[0], col_starts[-1] + 25)
               for row in np.arange(h // 8, h - h // 8 - line_height, int(line_height * 1.6))]
    if i % 3 == 0:
        regions.append((2, int(h * 0.7), int(h * 0.85), int(w * 0.2), int(w * 0.8)))
    return [tuple(int(v) for v in r) for r in regions]


def layout_labels(i: int, h: int, w: int) -> np.ndarray:
    """The class map of ``synthesize_pages``' page ``i``: ``layout_regions``
    painted on background (0)."""
    labels = np.zeros((h, w), np.uint8)
    for cls, r0, r1, c0, c1 in layout_regions(i, h, w):
        labels[r0:r1, c0:c1] = cls
    return labels


def _write_training_set(root: str, pages, binaries):
    """``create-dataset-file``'s layout under ``root``: 8-bit images, 1-bit
    binaries and RGB color masks, written by the port in parallel."""
    import os

    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.core.image_io import imsave, imsave_bilevel
    from page_segmentation_tpu_torch.data.dataset import io_pool

    for sub in ("images", "binary_images", "masks"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    def write(i):
        name = f"page{i:03d}.png"
        imsave(os.path.join(root, "images", name), pages[i])
        imsave_bilevel(os.path.join(root, "binary_images", name), binaries[i])
        imsave(os.path.join(root, "masks", name),
               DEFAULT_IMAGE_MAP.to_rgb_array(layout_labels(i, *pages[i].shape)))

    list(io_pool().map(write, range(len(pages))))


@backend_flags("train")
def phase_train(pages, binaries, work: str):
    """The training path on TRAIN_PAGES A4 pages at the full width of
    FCNSkip (3 classes, weights init_params_numpy(3, SEED)): the CLI's
    create-dataset-file and train (float32, TF32 as PyTorch sets it), the
    checkpoint decoded and predicted with, STEADY_STEPS steps timed between
    CUDA events, one step with TF32 off held against the CPU, and one epoch
    with device augmentation."""
    import os

    from page_segmentation_tpu_torch.cli.main import main as cli
    from page_segmentation_tpu_torch.data.augment_device import (
        DeviceAugmentConfig,
        _warp,
        augment_batch_on_device,
    )
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.train import trainer as trainer_module
    from page_segmentation_tpu_torch.train.checkpoint import load_checkpoint, load_opt_state
    from page_segmentation_tpu_torch.train.metrics import loss as ce_loss
    from page_segmentation_tpu_torch.train.steps import make_step_fns

    # PyTorch's defaults, as a fresh `train` CLI process has them
    t_phase = time.perf_counter()
    tf32 = {k: v for k, v in current_flags().items() if "tf32" in k}
    data_dir, out = os.path.join(work, "train_set"), os.path.join(work, "train_out")
    t0 = time.perf_counter()
    _write_training_set(data_dir, pages[:TRAIN_PAGES], binaries[:TRAIN_PAGES])
    write_s = time.perf_counter() - t0
    split = os.path.join(work, "train_set.json")
    n_test = TRAIN_PAGES // 5
    rc = cli(["create-dataset-file", "--dataset_path", data_dir, "--character_height", str(LINE_HEIGHT),
              "--n_train", str(TRAIN_PAGES - n_test), "--n_test", str(n_test), "--output_file", split])
    with open(split) as f:
        counts = {k: len(v) for k, v in json.load(f).items()}
    if rc != 0 or counts != {"train": TRAIN_PAGES - n_test, "test": n_test, "eval": 0}:
        raise AssertionError(f"create-dataset-file returned {rc}, splits {counts}")
    log(f"phase train: {TRAIN_PAGES} A4 pages with color masks written in {write_s:.2f} s; "
        f"create-dataset-file: {counts}; TF32 {tf32}")

    # the CLI run, with the Trainer it builds kept for the timings
    built = []

    class Recorded(trainer_module.Trainer):
        def __init__(self, settings):
            built.append(time.perf_counter())
            super().__init__(settings)
            built.append(self)

    cuda_cc.launches = cuda_add_one.launches = 0
    torch.cuda.reset_peak_memory_stats()
    trainer_module.Trainer, plain_trainer = Recorded, trainer_module.Trainer
    t0 = time.perf_counter()
    try:
        rc = cli(["train", "--device", DEVICE, "--split_file", split, "--output", out,
                  "--batch_size", str(TRAIN_BATCH), "--n_epoch", str(TRAIN_EPOCHS), "--l_rate", "1e-3",
                  "--target_line_height", "6"])
        torch.cuda.synchronize()
    finally:
        trainer_module.Trainer = plain_trainer
    cli_s = time.perf_counter() - t0
    launches = {"cc_label": cuda_cc.launches, "add_one": cuda_add_one.launches}
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    loader_s, trainer = built[0] - t0, built[1]
    with open(os.path.join(out, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]
    losses = [r["loss"] for r in scalars]
    if rc != 0 or len(losses) != TRAIN_EPOCHS or not losses[-1] < losses[0]:
        raise AssertionError(f"train returned {rc}, epoch losses {losses}")
    if any(launches.values()):
        raise AssertionError(f"kernels launched on the train path: {launches}")
    epochs = [{"epoch": t["epoch"], "pages_per_s": t["pages"] / t["train_s"], "train_s": t["train_s"],
               "val_s": t["eval_s"], "checkpoint_s": t["save_s"]} for t in trainer.timings]
    log(f"  train CLI: {cli_s:.2f} s in all, loader {loader_s:.2f} s; epoch losses "
        f"{[round(v, 5) for v in losses]}, val losses {[round(r['val_loss'], 5) for r in scalars]}; "
        f"peak CUDA memory {peak_mb:.1f} MiB; launches {launches}")
    for e in epochs:
        log(f"  epoch {e['epoch']}: {trainer.timings[e['epoch']]['pages']} pages in {e['train_s'] * 1e3:.1f} ms "
            f"= {e['pages_per_s']:.2f} pages/s; validation {e['val_s'] * 1e3:.1f} ms; "
            f"checkpoint {e['checkpoint_s'] * 1e3:.1f} ms")

    # the checkpoint: the expected trees, and a prediction with it
    model = os.path.join(out, "model")
    variables, meta = load_checkpoint(model)
    shapes = {k: v["kernel"].shape for k, v in variables["params"].items()}
    if shapes != {k: v["kernel"].shape for k, v in init_params_numpy(3, SEED).items()} \
            or meta.get("epoch") is None:
        raise AssertionError(f"checkpoint kernels {shapes}, meta {meta}")
    template = trainer.optimizer.state_dict(trainer.optimizer.init(params_from_jax(variables["params"])))
    opt_state = load_opt_state(model, template=template)
    steps = (meta["epoch"] + 1) * -(-(TRAIN_PAGES - n_test) // TRAIN_BATCH)
    if int(opt_state["count"]) != steps:
        raise AssertionError(f"opt_state count {opt_state['count']}, {steps} steps to epoch {meta['epoch']}")
    data = trainer.settings.validation_data.data
    _, prob, pred = PixelClassifier(3, model_path=model, device=DEVICE).predict_single_data(data[0])
    if pred.shape != data[0].image.shape or not np.isfinite(prob).all():
        raise AssertionError(f"prediction shape {pred.shape}")
    log(f"  checkpoint of epoch {meta['epoch']}: params {len(shapes)} layers, opt_state in optax's Adam "
        f"layout with count {int(opt_state['count'])}; PixelClassifier predicts {pred.shape} with it")

    # steady steps on one uploaded batch
    train_pages = trainer.settings.train_data.data[:TRAIN_BATCH]
    build_ms, upload_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        host = trainer._make_batch(train_pages, augment=False, rng=None)
        staged = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory() for k, v in host.items()}
        t1 = time.perf_counter()
        batch = {k: v.to(DEVICE, non_blocking=True) for k, v in staged.items()}
        torch.cuda.synchronize()
        build_ms.append((t1 - t0) * 1e3)
        upload_ms.append((time.perf_counter() - t1) * 1e3)
    batch = trainer._take_batch(trainer._place_batch(host))
    shape = tuple(batch["image"].shape)
    params, opt = dict(trainer._live()), trainer.opt_state
    for _ in range(3):
        params, _, opt, _ = trainer._train_step(params, {}, opt, batch, None)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(STEADY_STEPS):
        params, _, opt, metrics = trainer._train_step(params, {}, opt, batch, None)
        trainer._assign(params)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / STEADY_STEPS
    host_step_ms = (time.perf_counter() - t0) * 1e3 / STEADY_STEPS
    log(f"  steady train_step at batch {TRAIN_BATCH} on {shape}: {step_ms:.3f} ms a step (CUDA events; "
        f"host clock {host_step_ms:.3f}) = {TRAIN_BATCH / step_ms * 1e3:.2f} pages/s; host batch build "
        f"(pad, pin) {min(build_ms):.3f} ms, upload {min(upload_ms):.3f} ms (best of 5)")

    # where a step's device time goes, and the card's idle share in an epoch
    def steps():
        state = (params, opt)
        for _ in range(5):
            new, _, o, _ = trainer._train_step(state[0], {}, state[1], batch, None)
            state = (new, o)

    wall_us, busy_us, by_name, _ = profiled(steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profile of 5 steps: device busy {busy_us / 5e3:.3f} ms a step of {wall_us / 5e3:.3f} ms, "
        f"{len(by_name)} kernel names; top: " + "; ".join(
            f"{us / 5e3:.3f} ms {name[:60]}" for name, us in top))
    epoch_settings = trainer.settings._replace(n_epoch=1, validation_data=None, evaluation_data=None,
                                               output_dir=os.path.join(work, "train_profiled"))
    epoch_trainer = plain_trainer(epoch_settings)
    e_wall, e_busy, _, _ = profiled(epoch_trainer.train)
    idle_share = 1 - e_busy / e_wall
    log(f"  profile of one epoch ({TRAIN_PAGES - n_test} pages, checkpoint included): {e_wall / 1e3:.1f} ms, "
        f"device busy {e_busy / 1e3:.1f} ms, idle share {idle_share:.4f}")

    # one float32 step from the checkpoint's weights, TF32 off, on the card
    # and on the CPU
    t0 = time.perf_counter()
    with backend_flags("train: card vs CPU step", NO_TF32):
        jax_tree = variables["params"]
        grads = {}
        for device in (DEVICE, "cpu"):
            step, _ = make_step_fns(FCNSkip(3).to(device), Optimizers.ADAM.make(1e-3), ce_loss,
                                    device_preprocess=Architecture.FCN_SKIP.device_preprocess())
            p = {k: v.to(device) for k, v in params_from_jax(jax_tree).items()}
            b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
            loss_value, g = step.value_and_grad(p, {}, b)
            grads[device] = (float(loss_value), {k: v.double().cpu() for k, v in g.items()})
        torch.cuda.synchronize()
    (card_loss, card_g), (cpu_loss, cpu_g) = grads[DEVICE], grads["cpu"]
    loss_rel = abs(card_loss - cpu_loss) / abs(cpu_loss)
    rel = {k: float((card_g[k] - cpu_g[k]).norm() / cpu_g[k].norm().clamp_min(1e-30)) for k in cpu_g}
    worst = max(rel, key=rel.get)
    grad_rel = rel[worst]
    log(f"  card vs CPU, one float32 step from the checkpoint (TF32 off): loss {card_loss:.8f} vs "
        f"{cpu_loss:.8f} (rel {loss_rel:.3e}); largest gradient difference {grad_rel:.3e} of the "
        f"leaf's norm ({worst}); {time.perf_counter() - t0:.2f} s")
    if loss_rel > 1e-5 or grad_rel > 1e-3:
        raise AssertionError(f"card vs CPU: loss rel {loss_rel}, gradient rel {grad_rel}")

    # device augmentation: an epoch through the Trainer, then the warp's checks
    aug_settings = trainer.settings._replace(n_epoch=1, data_augmentation=True, device_augmentation=True,
                                             validation_data=None, evaluation_data=None,
                                             output_dir=os.path.join(work, "train_aug"))
    t0 = time.perf_counter()
    aug_history = plain_trainer(aug_settings).train()
    torch.cuda.synchronize()
    aug_s = time.perf_counter() - t0
    images = trainer.preprocess(host["image"].astype(np.float32))
    fimage = torch.from_numpy(np.ascontiguousarray(images, np.float32)).to(DEVICE)
    generator = torch.Generator(device=DEVICE).manual_seed(SEED)
    _, binary_a, mask_a = augment_batch_on_device(generator, fimage, batch["binary"], batch["mask"],
                                                  DeviceAugmentConfig(horizontal_flip=True))
    for i in range(mask_a.shape[0]):
        if not set(mask_a[i].unique().tolist()) <= set(batch["mask"][i].unique().tolist()):
            raise AssertionError(f"page {i}: warped mask classes outside the page's")
    identity = torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], device=DEVICE).expand(shape[0], 2, 3)
    if not (torch.equal(_warp(batch["mask"], identity, 0), batch["mask"])
            and torch.equal(_warp(fimage[..., 0], identity, 1), fimage[..., 0])):
        raise AssertionError("the identity warp changed its input")
    log(f"  device augmentation: one epoch in {aug_s:.2f} s, loss {aug_history['loss'][0]:.5f}; warped "
        f"mask classes within each page's, identity warp exact")
    phase_s = time.perf_counter() - t_phase
    log(f"  phase train: {phase_s:.1f} s")
    return {"launches": launches, "epochs": epochs, "loader_s": loader_s, "cli_s": cli_s,
            "phase_s": phase_s, "step_device_busy_ms": busy_us / 5e3,
            "step_top_kernels_ms": {name[:80]: us / 5e3 for name, us in top},
            "epoch_idle_share": idle_share,
            "peak_mib": peak_mb, "step_ms": step_ms, "host_step_ms": host_step_ms,
            "steady_pages_per_s": TRAIN_BATCH / step_ms * 1e3, "batch_build_ms": min(build_ms),
            "upload_ms": min(upload_ms), "batch_shape": list(shape), "losses": losses,
            "card_vs_cpu": {"loss_rel": loss_rel, "grad_rel_max": grad_rel, "grad_rel_max_leaf": worst}, "tf32": tf32,
            "device_augmentation_epoch_s": aug_s, "trainer": trainer}


def family_gflop_per_page(arch, channels: int, shape) -> float:
    """GFLOP of one page's forward (2 per multiply-add), counted by
    torch.utils.flop_counter on the meta device: shapes only, no compute."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        module = arch.model(3)
        x = torch.empty((1, channels) + tuple(shape))
    with FlopCounterMode(display=False) as counter:
        module.forward_nchw(x)
    return counter.get_total_flops() / 1e9


def calibrated_state(arch, x: torch.Tensor) -> dict:
    """The family's weights from the bridge's seeded init with every
    BatchNorm's statistics set to those of ``x`` (float32, TF32 off), as a
    CPU state_dict: random weights at mean 0 / var 1 blow activations up
    through the deep chains, and near-tied logits would then make every
    argmax comparison meaningless."""
    from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
    from page_segmentation_tpu_torch.models.layers import calibrate_batch_stats

    module = arch.model(3).to(DEVICE)
    module.load_state_dict(params_from_jax(init_variables_numpy(module, SEED)))
    with backend_flags(f"{arch.value}: calibration", NO_TF32):
        calibrate_batch_stats(module, x)
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


@backend_flags("families")
def phase_families(pages, binaries, work: str):
    """Each of FAMILIES at its published widths, weights from the bridge's
    seeded init with BatchNorm calibrated on one batch: its forward on the
    card against the CPU (float32, TF32 off) and bf16 against float32 on the
    card; ThroughputPredictor in bf16, download="packed", cc_vote="pallas"
    over N_PAGES A4 pages at batch BATCH (pages/s, device ms per batch, peak
    memory, idle share, cc_label launches); the device vote against the
    plain labeler's vote on the same predictions.  Then mobile_net from a
    msgpack checkpoint through PixelClassifier.predict_batch_masks with the
    device vote, against the CPU port."""
    import os

    from page_segmentation_tpu_torch import native
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.output import finish_mask_trio, unpack_bits_device
    from page_segmentation_tpu_torch.inference.pipeline import (
        ThroughputPredictor,
        _device_normalize,
        make_fused_predict,
    )
    from page_segmentation_tpu_torch.models.bridge import params_to_jax
    from page_segmentation_tpu_torch.models.registry import Architecture
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    palette = DEFAULT_IMAGE_MAP.palette
    (out_h, out_w), _ = normalized_shapes()
    dec = torch.from_numpy(native.decimate_u8(pages[:CALIBRATION_PAGES], HOST_DECIMATE)).to(DEVICE)
    n_batches = -(-N_PAGES // BATCH)
    results, states = {}, {}
    for name in FAMILIES:
        t_family = time.perf_counter()
        arch = Architecture(name)
        stride = arch.stride_factor
        padded = (-(-out_h // stride) * stride, -(-out_w // stride) * stride)
        normalize = _device_normalize(out_h, out_w, *padded, arch.preprocess_mode)
        states[name] = state = calibrated_state(arch, normalize(dec))
        channels = 3 if arch.preprocess()[1] else 1
        gflop = family_gflop_per_page(arch, channels, padded)

        # the forward: card float32 vs CPU, card bf16 vs card float32
        x = normalize(dec[:CHECK_PAGES])
        module = {}
        for key, device, dtype in (("card32", DEVICE, torch.float32), ("cpu32", "cpu", torch.float32),
                                   ("card16", DEVICE, torch.bfloat16)):
            module[key] = arch.model(3, dtype=dtype).to(device)
            module[key].load_state_dict(state)
        with backend_flags(f"{name}: float32 card vs CPU", NO_TF32), torch.inference_mode():
            card32 = module["card32"].forward_nchw(x).cpu()
        with torch.inference_mode():
            cpu32 = module["cpu32"].forward_nchw(x.cpu())
            card16 = module["card16"].forward_nchw(x.to(torch.bfloat16)).cpu()
        rel_err = float((card32 - cpu32).abs().max() / cpu32.abs().max())
        f32_agree = float((card32.argmax(1) == cpu32.argmax(1)).float().mean())
        top2 = card32.topk(2, dim=1).values
        decisive = (top2[:, 0] - top2[:, 1]) >= DECISIVE * card32.abs().max()
        bf16_same = card16.argmax(1) == card32.argmax(1)
        bf16_all, bf16_decisive = float(bf16_same.float().mean()), float(bf16_same[decisive].float().mean())
        decisive_share = float(decisive.float().mean())
        log(f"phase families {name}: {gflop:.1f} GFLOP a page at {padded}; card vs CPU float32 on "
            f"{CHECK_PAGES} pages: max |d logit| {rel_err:.3e} of the largest, argmax agreement "
            f"{f32_agree:.6f}; card bf16 vs float32: {bf16_decisive:.6f} on the {decisive_share:.3f} "
            f"of pixels with a decisive margin, {bf16_all:.6f} on all (reported)")
        if f32_agree < 0.999 or decisive_share < 0.3 or bf16_decisive < 0.999:
            raise AssertionError(f"{name}: the forward on the card disagrees (float32 {f32_agree}, "
                                 f"bf16 {bf16_decisive} on {decisive_share} of pixels)")
        bf16 = module["card16"]
        del module

        # the throughput path, bf16, device vote
        tp = ThroughputPredictor(
            bf16, None, palette, A4, SCALE, host_decimate=HOST_DECIMATE,
            stride_factor=stride, compute_dtype=torch.bfloat16, download="packed", cc_vote="pallas",
            preprocess_mode=arch.preprocess_mode, device=DEVICE)
        tp.execute_batch(tp.prep_batch(pages[:BATCH], binaries[:BATCH]))  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        outs = [tuple(a.copy() for a in trio) for trio in tp.run(pages, binaries, batch_size=BATCH)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, peak_mib = cuda_cc.launches, torch.cuda.max_memory_allocated() / 2 ** 20
        if launches != cuda_cc.LAUNCHES_PER_CALL * n_batches or cuda_add_one.launches:
            raise AssertionError(f"{name}: cc_label launched {launches} times (expected "
                                 f"{cuda_cc.LAUNCHES_PER_CALL * n_batches}), add_one {cuda_add_one.launches}")
        for trio in outs:
            for arr in trio:
                if arr.shape != (BATCH, out_h, out_w, 3) or arr.dtype != np.uint8:
                    raise AssertionError(f"{name}: trio array {arr.shape} {arr.dtype}")

        prepared = tp.prep_batch(pages[:BATCH], binaries[:BATCH])
        dec_t, ink_t = tp.transfers.take(prepared[0]), tp.transfers.take(prepared[2])
        device_ms = cuda_ms(lambda: tp.fused(dec_t, tp.palette_dev, ink_t), reps=5, warmup=1)
        wall_us, busy_us, by_name, _ = profiled(lambda: [None for _ in tp.run(pages, binaries, batch_size=BATCH)])
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]

        # the vote: kernel == plain labeler on one dispatch's predictions
        unvoted = make_fused_predict(bf16, (out_h, out_w), stride_factor=stride,
                                     compute_dtype=torch.bfloat16, download="pred",
                                     preprocess_mode=arch.preprocess_mode, device=DEVICE)(dec_t, tp.palette_dev)
        ink = unpack_bits_device(ink_t)
        voted = cuda_cc.cc_vote_batch(unvoted, ink, 3, device=DEVICE)
        plain = cuda_cc._vote_from_labels(unvoted, ink, cuda_cc.cc_min_label_reference(ink)[0], 3)
        if not torch.equal(voted, plain):
            raise AssertionError(f"{name}: device vote != plain labeler's vote on the same predictions")
        trio_agree = float(np.mean(outs[0][0] == finish_mask_trio(voted.cpu().numpy(), prepared[1], palette)[0]))
        if trio_agree < 0.999:
            raise AssertionError(f"{name}: run() colors agree with the checked vote on {trio_agree}")
        results[name] = {
            "gflop_per_page": gflop, "padded_shape": list(padded), "pages_per_s": N_PAGES / wall,
            "device_ms_per_batch": device_ms, "forward_tflop_s": gflop * BATCH / device_ms,
            "peak_mib": peak_mib, "idle_share": 1 - busy_us / wall_us,
            "cc_label_launches": launches, "card_vs_cpu_rel_logit_err": rel_err,
            "card_vs_cpu_argmax": f32_agree, "bf16_vs_f32_decisive": bf16_decisive,
            "bf16_vs_f32_all": bf16_all, "decisive_share": decisive_share,
            "relabeled_px": int((voted != unvoted).sum()), "family_s": time.perf_counter() - t_family,
            "run_top_kernels_ms": {k[:80]: us / 1e3 for k, us in top}}
        log(f"  {name} throughput: {N_PAGES} pages at batch {BATCH} in {wall:.3f} s = "
            f"{N_PAGES / wall:.2f} pages/s; device program {device_ms:.3f} ms a batch "
            f"(the forward's FLOPs at {results[name]['forward_tflop_s']:.1f} TFLOP/s of it); peak {peak_mib:.1f} MiB; "
            f"idle share {results[name]['idle_share']:.4f} (profiled run); cc_label launches {launches}; "
            f"device vote == plain labeler's ({results[name]['relabeled_px']} px relabeled), run() colors "
            f"agree {trio_agree:.6f} with it; {results[name]['family_s']:.1f} s")
        log(f"  {name} profiled run, device ms by kernel: " + "; ".join(
            f"{us / 1e3:.3f} {k[:60]}" for k, us in top))
        del tp, bf16
        torch.cuda.empty_cache()

    # the RGB family on the library batch path, from a msgpack checkpoint
    arch = Architecture.MOBILE_NET
    model = os.path.join(work, "mobile_net")
    save_checkpoint(model, params_to_jax(states["mobile_net"]), {"architecture": arch.value, "n_classes": 3})
    bucket = (-(-out_h // 32) * 32, -(-out_w // 32) * 32)
    images = np.zeros((LIBRARY_BATCH,) + bucket, np.uint8)
    bins = np.zeros_like(images)
    images[:, :out_h, :out_w] = 255 - dec[:LIBRARY_BATCH, :out_h, :out_w].cpu().numpy()  # ink bright
    bins[:, :out_h, :out_w] = images[:, :out_h, :out_w] > 127
    card = PixelClassifier(3, model_path=model, device=DEVICE)
    cpu = PixelClassifier(3, model_path=model, device="cpu")
    if card.architecture is not arch or cpu.architecture is not arch:
        raise AssertionError(f"the checkpoint loads as {card.architecture}")
    with backend_flags("families: mobile_net library batch", NO_TF32):
        card.predict_batch_masks(images, bins, palette, device_vote=True)  # warm-up
        torch.cuda.synchronize()
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        got_pred, got_trio = card.predict_batch_masks(images, bins, palette, device_vote=True)
        library_s, library_launches = time.perf_counter() - t0, cuda_cc.launches
    if library_launches != cuda_cc.LAUNCHES_PER_CALL or cuda_add_one.launches:
        raise AssertionError(f"mobile_net library batch: cc_label launches {library_launches}")
    want_pred, want_trio = cpu.predict_batch_masks(images, bins, palette, device_vote=True)
    agree = got_pred == want_pred
    if agree.mean() < 0.999 or not all(np.array_equal(g[agree], w[agree]) for g, w in zip(got_trio, want_trio)):
        raise AssertionError(f"mobile_net library batch: labels agree on {agree.mean()}, or the trio differs")
    log(f"  mobile_net from a msgpack checkpoint, predict_batch_masks(device_vote=True) at "
        f"{(LIBRARY_BATCH,) + bucket}: {library_s * 1e3:.1f} ms (float32, TF32 off); labels agree with "
        f"the CPU port on {agree.mean():.6f}, trio equal wherever they agree; cc_label launches "
        f"{library_launches}")
    return {"families": results, "library_launches": library_launches,
            "library_agreement": float(agree.mean())}


def frozen_digests():
    """``tests/make_flax_init_digests.py``, loaded from its file: the frozen
    file's path, its leaf walk and its comparison (no JAX at import)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "make_flax_init_digests.py")
    spec = importlib.util.spec_from_file_location("make_flax_init_digests", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@backend_flags("init")
def phase_init(pages, binaries):
    """Fresh models from flax's draw: for each architecture,
    ``PixelClassifier(3, architecture, seed=SEED)`` on the card, timed, and
    the draw alone (``init_variables`` of the module's shapes), timed; every
    leaf of its variables, and of its weights read back from the card, held
    against the frozen digests of the JAX package's init; effb7's draw
    within INIT_DRAW_LIMIT_S.  Then one ThroughputPredictor batch of each of
    INIT_THROUGHPUT from its fresh bf16 weights (download="packed",
    cc_vote="pallas"), the labeler launched LAUNCHES_PER_CALL times, and the
    device vote held against the plain labeler's on the same predictions."""
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.output import unpack_bits_device
    from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor, make_fused_predict
    from page_segmentation_tpu_torch.models.bridge import init_variables, params_to_jax
    from page_segmentation_tpu_torch.models.registry import Architecture
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc

    digests = frozen_digests()
    with open(digests.PATH) as f:
        frozen = json.load(f)
    if frozen["seed"] != SEED or frozen["n_classes"] != 3:
        raise AssertionError(f"{digests.PATH} holds seed {frozen['seed']}, {frozen['n_classes']} classes")
    draws = {}
    for arch in Architecture:
        t0 = time.perf_counter()
        clf = PixelClassifier(3, architecture=arch, seed=SEED, device=DEVICE)
        torch.cuda.synchronize()
        classifier_s = time.perf_counter() - t0
        with torch.device("meta"):
            shapes = arch.model(3)
        t0 = time.perf_counter()
        init_variables(shapes, SEED)
        draw_s = time.perf_counter() - t0
        entry = frozen["models"][arch.value]
        n_leaves = sum(1 for _ in digests.leaves(entry))
        bad = digests.mismatches(clf.variables, entry, frozen["digests"])
        on_card = params_to_jax(clf.module.state_dict())
        on_card = on_card if "params" in on_card else {"params": on_card}
        bad_card = digests.mismatches(on_card, entry, frozen["digests"])
        n_values = sum(p.numel() for p in clf.module.parameters())
        draws[arch.value] = {"parameters": n_values, "leaves": n_leaves,
                             "bit_equal_leaves": n_leaves - len(bad), "classifier_s": classifier_s,
                             "draw_s": draw_s}
        log(f"phase init {arch.value}: PixelClassifier(3, seed={SEED}) in {classifier_s:.3f} s, the "
            f"draw alone {draw_s:.3f} s ({n_values} parameters); {n_leaves - len(bad)} of {n_leaves} "
            f"leaves bit-equal to the JAX package's, {n_leaves - len(bad_card)} on the card")
        if bad or bad_card:
            raise AssertionError(f"{arch.value}: leaves differ from {digests.PATH}: "
                                 f"{(bad or bad_card)[:5]}")
        del clf
    if draws["effb7"]["draw_s"] > INIT_DRAW_LIMIT_S:
        raise AssertionError(f"effb7's fresh draw took {draws['effb7']['draw_s']:.2f} s "
                             f"(limit {INIT_DRAW_LIMIT_S} s)")

    palette = DEFAULT_IMAGE_MAP.palette
    (out_h, out_w), _ = normalized_shapes()
    throughput, launches = {}, {"cc_label": 0, "add_one": 0}
    for name in INIT_THROUGHPUT:
        arch = Architecture(name)
        bf16 = PixelClassifier(3, architecture=arch, seed=SEED, compute_dtype=torch.bfloat16,
                               device=DEVICE).module
        tp = ThroughputPredictor(
            bf16, None, palette, A4, SCALE, host_decimate=HOST_DECIMATE,
            stride_factor=arch.stride_factor, compute_dtype=torch.bfloat16, download="packed",
            cc_vote="pallas", preprocess_mode=arch.preprocess_mode, device=DEVICE)
        torch.cuda.synchronize()
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        outs = [tuple(a.copy() for a in trio) for trio in tp.run(pages[:BATCH], binaries[:BATCH],
                                                                batch_size=BATCH)]
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        n_launches = cuda_cc.launches
        launches["cc_label"] += n_launches
        launches["add_one"] += cuda_add_one.launches
        if n_launches != cuda_cc.LAUNCHES_PER_CALL or cuda_add_one.launches:
            raise AssertionError(f"{name}: cc_label launched {n_launches} times (expected "
                                 f"{cuda_cc.LAUNCHES_PER_CALL}), add_one {cuda_add_one.launches}")
        if len(outs) != 1 or any(a.shape != (BATCH, out_h, out_w, 3) or a.dtype != np.uint8
                                 for a in outs[0]):
            raise AssertionError(f"{name}: trio {[[(a.shape, a.dtype) for a in t] for t in outs]}")
        # the vote: kernel == plain labeler on one dispatch's predictions
        prepared = tp.prep_batch(pages[:BATCH], binaries[:BATCH])
        dec_t, ink_t = tp.transfers.take(prepared[0]), tp.transfers.take(prepared[2])
        unvoted = make_fused_predict(bf16, (out_h, out_w), stride_factor=arch.stride_factor,
                                     compute_dtype=torch.bfloat16, download="pred",
                                     preprocess_mode=arch.preprocess_mode, device=DEVICE)(dec_t, tp.palette_dev)
        ink = unpack_bits_device(ink_t)
        voted = cuda_cc.cc_vote_batch(unvoted, ink, 3, device=DEVICE)
        plain = cuda_cc._vote_from_labels(unvoted, ink, cuda_cc.cc_min_label_reference(ink)[0], 3)
        if not torch.equal(voted, plain):
            raise AssertionError(f"{name}: device vote != plain labeler's vote on the same predictions")
        classes = torch.bincount(unvoted.flatten().long(), minlength=3).tolist()
        throughput[name] = {"batch_s": batch_s, "cc_label_launches": n_launches,
                            "predicted_px_by_class": classes,
                            "relabeled_px": int((voted != unvoted).sum())}
        log(f"  {name} from its fresh weights: one throughput batch of {BATCH} A4 pages in "
            f"{batch_s:.3f} s (first call, cuDNN plans included); cc_label launches "
            f"{n_launches}; predicted pixels by class {classes}; device vote == plain "
            f"labeler's ({throughput[name]['relabeled_px']} px relabeled)")
        del tp, bf16
        torch.cuda.empty_cache()
    return {"draws": draws, "throughput": throughput, "launches": launches}


@backend_flags("train families")
def phase_train_families(trainer, work: str):
    """The Trainer on TRAIN_FAMILIES (BatchNorm, dropout) over phase_train's
    data at batch TRAIN_BATCH for FAMILY_EPOCHS epochs at FAMILY_LR, float32
    with TF32 as PyTorch sets it: the BatchNorm statistics calibrated by one step with
    momentum 0 and saved as the start checkpoint; epoch times, peak memory,
    steady train_step ms; for the BatchNorm family one float32 step (TF32
    off) on the card against the CPU from that checkpoint: loss, gradients
    and updated batch_stats."""
    import os

    from page_segmentation_tpu_torch.models.bridge import params_from_jax
    from page_segmentation_tpu_torch.models.layers import BatchNorm
    from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.train import trainer as trainer_module
    from page_segmentation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from page_segmentation_tpu_torch.train.metrics import loss as ce_loss
    from page_segmentation_tpu_torch.train.steps import make_step_fns

    train_pages = trainer.settings.train_data.data
    results, launches = {}, {"cc_label": 0, "add_one": 0}
    for name in TRAIN_FAMILIES:
        arch = Architecture(name)
        out = os.path.join(work, f"train_{name}")
        run = trainer_module.Trainer(trainer.settings._replace(
            architecture=arch, n_epoch=FAMILY_EPOCHS, l_rate=FAMILY_LR, output_dir=out,
            evaluation_data=None))
        host = run._make_batch(train_pages[:TRAIN_BATCH], augment=False, rng=None)
        batch = run._take_batch(run._place_batch(host))
        batch_norms = [m for m in run.module.modules() if isinstance(m, BatchNorm)]
        if batch_norms:  # running statistics := one batch's (a step with momentum 0)
            momenta = [bn.momentum for bn in batch_norms]
            for bn in batch_norms:
                bn.momentum = 0.0
            _, stats, _, _ = run._train_step(run._live(), run._live_state(), run.opt_state, batch, None)
            run._assign({}, stats)
            for bn, m in zip(batch_norms, momenta):
                bn.momentum = m
        start = os.path.join(work, f"start_{name}")
        save_checkpoint(start, {"params": run.params, **run.model_state},
                        {"architecture": name, "n_classes": 3})

        cuda_cc.launches = cuda_add_one.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        history = run.train()
        torch.cuda.synchronize()
        train_s, peak_mib = time.perf_counter() - t0, torch.cuda.max_memory_allocated() / 2 ** 20
        launches["cc_label"] += cuda_cc.launches
        launches["add_one"] += cuda_add_one.launches
        losses = history["loss"]
        if len(losses) != FAMILY_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"{name}: epoch losses {losses}")
        variables, meta = load_checkpoint(os.path.join(out, "model"))
        if set(variables) != ({"params", "batch_stats"} if batch_norms else {"params"}):
            raise AssertionError(f"{name}: checkpoint collections {sorted(variables)}")
        epochs = [{"epoch": t["epoch"], "pages_per_s": t["pages"] / t["train_s"], "val_s": t["eval_s"],
                   "checkpoint_s": t["save_s"]} for t in run.timings]

        # steady steps on one uploaded batch (UNet's dropout from a generator)
        params, state, opt = dict(run._live()), dict(run._live_state()), run.opt_state
        dropout_rng = torch.Generator(device=DEVICE).manual_seed(SEED)
        for _ in range(3):
            params, state, opt, _ = run._train_step(params, state, opt, batch, dropout_rng)
        torch.cuda.synchronize()
        start_event, end_event = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_event.record()
        for _ in range(FAMILY_STEADY_STEPS):
            params, state, opt, _ = run._train_step(params, state, opt, batch, dropout_rng)
            run._assign(params, state)
        end_event.record()
        torch.cuda.synchronize()
        step_ms = start_event.elapsed_time(end_event) / FAMILY_STEADY_STEPS

        def steps():
            state_ = (params, state, opt)
            for _ in range(5):
                p_, s_, o_, _ = run._train_step(*state_, batch, dropout_rng)
                state_ = (p_, s_, o_)

        wall_us, busy_us, by_name, _ = profiled(steps)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        results[name] = {"losses": losses, "val_losses": history.get("val_loss"), "train_s": train_s,
                         "epochs": epochs, "peak_mib": peak_mib, "step_ms": step_ms,
                         "step_device_busy_ms": busy_us / 5e3,
                         "step_top_kernels_ms": {k[:80]: us / 5e3 for k, us in top},
                         "batch_shape": list(batch["image"].shape), "checkpoint_epoch": meta.get("epoch")}
        log(f"phase train families {name}: {FAMILY_EPOCHS} epochs in {train_s:.2f} s, losses "
            f"{[round(v, 5) for v in losses]}; epochs " + ", ".join(
                f"{e['pages_per_s']:.2f} pages/s" for e in epochs)
            + f"; peak CUDA memory {peak_mib:.1f} MiB; steady train_step at batch {TRAIN_BATCH} on "
            f"{tuple(batch['image'].shape)}: {step_ms:.3f} ms; checkpoint holds {sorted(variables)}")
        log(f"  profile of 5 steps: device busy {busy_us / 5e3:.3f} ms a step of {wall_us / 5e3:.3f} ms, "
            f"{len(by_name)} kernel names; top: " + "; ".join(f"{us / 5e3:.3f} ms {k[:70]}" for k, us in top))

        if not batch_norms:
            continue
        # one float32 step, TF32 off, on the card and on the CPU from the start checkpoint
        start_vars, _ = load_checkpoint(start)
        small = run._make_batch(train_pages[:CHECK_PAGES], augment=False, rng=None)
        got = {}
        with backend_flags(f"{name}: card vs CPU step", NO_TF32):
            for device in (DEVICE, "cpu"):
                module = arch.model(3).to(device)
                step, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), ce_loss,
                                        device_preprocess=arch.device_preprocess())
                tensors = {k: v.to(device) for k, v in params_from_jax(start_vars).items()}
                p = {k: tensors[k] for k, _ in module.named_parameters()}
                s = {k: tensors[k] for k, _ in module.named_buffers()}
                b = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in small.items()}
                loss_value, g, new_s = step.value_and_grad(p, s, b, with_state=True)
                got[device] = (float(loss_value), {k: v.double().cpu() for k, v in g.items()},
                               {k: v.double().cpu() for k, v in new_s.items()})
            torch.cuda.synchronize()

        def rel(a, b):
            flat_a, flat_b = (torch.cat([t.flatten() for _, t in sorted(x.items())]) for x in (a, b))
            return float((flat_a - flat_b).norm() / flat_b.norm())

        (card_loss, card_g, card_s), (cpu_loss, cpu_g, cpu_s) = got[DEVICE], got["cpu"]
        check = {"loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss), "grad_rel": rel(card_g, cpu_g),
                 "batch_stats_rel": rel(card_s, cpu_s)}
        results[name]["card_vs_cpu"] = check
        log(f"  {name} card vs CPU, one float32 step from the calibrated start (TF32 off): loss "
            f"{card_loss:.8f} vs {cpu_loss:.8f} (rel {check['loss_rel']:.3e}); gradients {check['grad_rel']:.3e} "
            f"and updated batch_stats {check['batch_stats_rel']:.3e} relative in norm")
        if check["loss_rel"] > 1e-5 or check["grad_rel"] > 1e-3 or check["batch_stats_rel"] > 1e-4:
            raise AssertionError(f"{name} card vs CPU step: {check}")
    if any(launches.values()):
        raise AssertionError(f"kernels launched on the families' train path: {launches}")
    return {"families": results, "launches": launches}


@backend_flags("mesh", {"cudnn.deterministic": True})
def phase_mesh(pages, binaries, model: str, train_settings, work: str):
    """Several devices on one card: a mesh that holds the card MESH_SHARDS
    times, so the halo copies, the per-shard labeler and the gradient sums
    run, though nothing crosses between cards.  Every path below runs with
    the kernels' counts set to 0 just before it; only the throughput path
    may launch the labeler, exactly LAUNCHES_PER_CALL a shard a batch."""
    import os
    import socket

    import torch.distributed as dist

    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.data.dataset import SingleData
    from page_segmentation_tpu_torch.data.loader import DatasetLoader
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.ops.pad import pad_to
    from page_segmentation_tpu_torch.parallel import distributed
    from page_segmentation_tpu_torch.parallel.executor import ParallelPredictor
    from page_segmentation_tpu_torch.parallel.mesh import make_mesh
    from page_segmentation_tpu_torch.parallel.spatial import (
        DEFAULT_MARGINS,
        spatial_forward,
        spatial_forward_batch,
    )
    from page_segmentation_tpu_torch.train.checkpoint import OrbaxCheckpointer, load_checkpoint
    from page_segmentation_tpu_torch.train.metrics import loss as ce_loss
    from page_segmentation_tpu_torch.train.steps import make_step_fns
    from page_segmentation_tpu_torch.train.trainer import Trainer

    card = torch.device(DEVICE if DEVICE == "cpu" else f"{DEVICE}:0")
    mesh = make_mesh(devices=[card] * MESH_SHARDS)
    report, launches = {"shards": MESH_SHARDS, "mesh": repr(mesh)}, {}

    def counted(name, fn):
        """Run one path with the launch counts set to 0 just before it."""
        torch.cuda.synchronize()
        cuda_cc.launches = cuda_add_one.launches = 0
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[name] = {"cc_label": cuda_cc.launches, "add_one": cuda_add_one.launches}
        return wall, result

    def peak_mib(fn):
        """Peak device memory of ``fn`` above what was allocated before it."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 2**20

    def rel(a, b):
        flat_a, flat_b = (torch.cat([t.double().cpu().flatten() for _, t in sorted(x.items())])
                          for x in (a, b))
        return float((flat_a - flat_b).norm() / flat_b.norm())

    # ---- 1. the throughput cell, data-parallel over the mesh
    variables, _ = load_checkpoint(model)
    module = FCNSkip(3, dtype=torch.bfloat16)
    module.load_state_dict(params_from_jax(variables))

    def predictor(m):
        return ThroughputPredictor(module, None, DEFAULT_IMAGE_MAP.palette, A4, SCALE,
                                   host_decimate=HOST_DECIMATE, compute_dtype=torch.bfloat16,
                                   download="packed", cc_vote="pallas", mesh=m, device=DEVICE)

    tp_none, tp_mesh = predictor(None), predictor(mesh)
    ragged = (list(pages[:MESH_RAGGED]), list(binaries[:MESH_RAGGED]))

    def run(tp, n_pad):
        """The cell's batches, then the ragged batch as the serving engine
        stages it (``n_pad`` slots: the mesh pads its own to the shards)."""
        outs = [tuple(a.copy() for a in trio) for trio in tp.run(pages, binaries, batch_size=BATCH)]
        outs.append(tuple(a[:MESH_RAGGED].copy()
                          for a in tp.execute_batch(tp.prep_pages(*ragged, n_pad))))
        return outs

    # the no-mesh reference runs the ragged batch padded as the mesh pads it:
    # cuDNN may take another algorithm for another batch size (checked below)
    padded_n = -(-MESH_RAGGED // MESH_SHARDS) * MESH_SHARDS
    for tp, n_pad in ((tp_none, padded_n), (tp_mesh, MESH_RAGGED), (tp_none, MESH_RAGGED)):
        tp.execute_batch(tp.prep_batch(pages[:BATCH], binaries[:BATCH]))  # warm-up, uncounted
        tp.execute_batch(tp.prep_pages(*ragged, n_pad))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    mesh_s, outs_mesh = counted("mesh_throughput", lambda: run(tp_mesh, MESH_RAGGED))
    card_peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    none_s, outs_none = counted("throughput_no_mesh", lambda: run(tp_none, padded_n))
    unpadded = tp_none.execute_batch(tp_none.prep_pages(*ragged, MESH_RAGGED))
    ragged_agree = float(np.mean([np.mean(a == b) for a, b in zip(unpadded, outs_none[-1])]))
    n_batches = -(-N_PAGES // BATCH) + 1
    want = {"mesh_throughput": cuda_cc.LAUNCHES_PER_CALL * MESH_SHARDS * n_batches,
            "throughput_no_mesh": cuda_cc.LAUNCHES_PER_CALL * n_batches}
    for name, count in want.items():
        if launches[name] != {"cc_label": count, "add_one": 0}:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {count} cc_label")
    for i, (got, ref) in enumerate(zip(outs_mesh, outs_none)):
        for a, b in zip(got, ref):
            if a.shape != b.shape or not np.array_equal(a, b):
                raise AssertionError(f"mesh throughput batch {i}: trio differs from no mesh")
    if outs_mesh[-1][0].shape[0] != MESH_RAGGED:
        raise AssertionError(f"ragged batch came back with {outs_mesh[-1][0].shape[0]} pages")
    device_ms = {}
    for name, tp in (("mesh", tp_mesh), ("none", tp_none)):
        prepared = tp.prep_batch(pages[:BATCH], binaries[:BATCH])
        dec_t, ink_t = tp._take(prepared[0]), tp._take(prepared[2])
        device_ms[name] = cuda_ms(lambda: tp.fused(dec_t, tp.palette_dev, ink_t), reps=5, warmup=1)
    prepared = tp_mesh.prep_batch(pages[:BATCH], binaries[:BATCH])
    dec_t, ink_t = tp_mesh._take(prepared[0]), tp_mesh._take(prepared[2])
    shard_peak = peak_mib(lambda: tp_mesh.fused(dec_t[:1], tp_mesh.palette_dev, ink_t[:1]))
    report["throughput"] = {
        "pages": N_PAGES + MESH_RAGGED, "batches": n_batches,
        "ms_per_batch_mesh": mesh_s * 1e3 / n_batches, "ms_per_batch_none": none_s * 1e3 / n_batches,
        "device_ms_per_batch_mesh": device_ms["mesh"], "device_ms_per_batch_none": device_ms["none"],
        "halo_bytes_per_page": 0, "card_peak_mib": card_peak, "shard_peak_mib": shard_peak,
        "cc_label_launches": launches["mesh_throughput"]["cc_label"],
        "no_mesh_ragged_47_vs_48_trio_agree": ragged_agree}
    log(f"phase mesh, throughput: {N_PAGES} pages at batch {BATCH} + {MESH_RAGGED} over "
        f"{MESH_SHARDS} shards of one card: {mesh_s * 1e3 / n_batches:.1f} ms a batch vs "
        f"{none_s * 1e3 / n_batches:.1f} without a mesh; device program {device_ms['mesh']:.3f} vs "
        f"{device_ms['none']:.3f} ms a batch of {BATCH}; peak {card_peak:.1f} MiB on the card, "
        f"{shard_peak:.1f} MiB for one shard alone; trio byte-equal to no mesh (no mesh on the "
        f"ragged batch at {MESH_RAGGED} vs {padded_n} slots: {ragged_agree:.6f} of trio bytes "
        f"equal); cc_label launches "
        f"{launches['mesh_throughput']['cc_label']} (= {cuda_cc.LAUNCHES_PER_CALL} x {MESH_SHARDS} "
        f"shards x {n_batches} batches)")

    # ---- 2. one large page in row bands across the mesh, halos exchanged
    net32 = PixelClassifier(3, model_path=model, device=DEVICE)
    page = 255 - synthesize_pages(1, *LARGE_PAGE, seed=SEED + 1, rules=True)[0][0]
    arr = Predictor(PredictSettings(n_classes=3), network=net32)._preprocessed_hwc(SingleData(image=page))
    margin = DEFAULT_MARGINS["fcn_skip"]
    one = make_mesh(devices=[card])
    space = make_mesh(devices=[card] * MESH_SHARDS, shape=(1, MESH_SHARDS), axis_names=("data", "space"))
    times = {}
    with backend_flags("mesh: spatial", {**NO_TF32, "cudnn.deterministic": True}):
        for _ in range(2):  # the first round warms every window shape up
            times["split"], split = counted("mesh_spatial", lambda: spatial_forward(
                net32.module, arr, mesh, margin=margin))
            times["whole"], whole = counted("whole_page", lambda: spatial_forward(
                net32.module, arr, one, margin=margin))
            times["batch"], batched = counted("mesh_spatial_batch", lambda: spatial_forward_batch(
                net32.module, arr[None], space, margin=margin))
        band_h = LARGE_PAGE[0] // MESH_SHARDS
        window = torch.from_numpy(np.ascontiguousarray(arr[None, : band_h + 2 * margin])).to(card)
        with torch.inference_mode():
            shard_peak = peak_mib(lambda: net32.module(window))
            whole_input = torch.from_numpy(np.ascontiguousarray(arr[None])).to(card)
            whole_peak = peak_mib(lambda: net32.module(whole_input))
        del window, whole_input
    spatial_err = float(np.abs(split - whole).max() / np.abs(whole).max())
    batch_err = float(np.abs(batched[0] - whole).max() / np.abs(whole).max())
    # labels: equal on every decisive pixel (a top-2 margin of at least
    # DECISIVE of the largest |logit|); a near-tie may flip under the ~1e-7
    # the other window shapes' convolutions move the logits by
    top2 = np.sort(whole, -1)[..., -2:]
    margins = top2[..., 1] - top2[..., 0]
    decisive = margins >= DECISIVE * np.abs(whole).max()
    flips = {}
    for name, got in (("split", split), ("batch", batched[0])):
        differ = got.argmax(-1) != whole.argmax(-1)
        flips[name] = {"pixels": int(differ.sum()), "decisive": int((differ & decisive).sum()),
                       "max_margin": float(margins[differ].max()) if differ.any() else 0.0}
    labels_equal = float((split.argmax(-1) == whole.argmax(-1)).mean())
    batch_labels_equal = float((batched[0].argmax(-1) == whole.argmax(-1)).mean())
    halo_bytes = 2 * (MESH_SHARDS - 1) * 2 * margin * arr.shape[1] * arr.shape[2] * 4
    report["spatial"] = {"page": list(LARGE_PAGE), "margin": margin, "rel_err": spatial_err,
                         "batch_rel_err": batch_err, "labels_equal": labels_equal,
                         "batch_labels_equal": batch_labels_equal, "ms_split": times["split"] * 1e3,
                         "ms_whole": times["whole"] * 1e3, "ms_batch_1x2": times["batch"] * 1e3,
                         "halo_bytes_per_page": halo_bytes, "shard_peak_mib": shard_peak,
                         "whole_peak_mib": whole_peak, "label_flips": flips,
                         "decisive_share": float(decisive.mean())}
    log(f"phase mesh, spatial: {LARGE_PAGE} float32 page (TF32 off) in {MESH_SHARDS} bands with "
        f"{margin}-row halos: {times['split'] * 1e3:.1f} ms vs whole {times['whole'] * 1e3:.1f} ms "
        f"(host transfers included), (1 data x {MESH_SHARDS} space) batch {times['batch'] * 1e3:.1f} "
        f"ms; max |d logit| / max |logit| {spatial_err:.2e} (batch {batch_err:.2e}); labels differ on "
        f"{flips['split']['pixels']} ({flips['batch']['pixels']}) of {whole.shape[0] * whole.shape[1]} "
        f"pixels, {flips['split']['decisive']} ({flips['batch']['decisive']}) decisive, largest top-2 "
        f"margin among them {flips['split']['max_margin']:.2e}; halo {halo_bytes} bytes a page between "
        f"neighbours (not copied on one card); one shard's window alone peaks at {shard_peak:.1f} "
        f"MiB, the whole page at {whole_peak:.1f} MiB")
    if max(spatial_err, batch_err) > 5e-4 or flips["split"]["decisive"] or flips["batch"]["decisive"]:
        raise AssertionError("the bands across the mesh disagree with the whole page")

    # ---- 3. ParallelPredictor: the executor over the mesh
    (out_h, out_w), padded = normalized_shapes()
    prepared_pages = DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=True).load_data([
        SingleData(image=pages[i], binary=binaries[i], line_height_px=LINE_HEIGHT)
        for i in range(MESH_EXECUTOR_PAGES)])
    images = np.stack([pad_to(d.image, padded) for d in prepared_pages.data])
    executor = ParallelPredictor(net32, mesh)
    with backend_flags("mesh: executor", {**NO_TF32, "cudnn.deterministic": True}):
        executor.predict_batch(images)  # warm-up
        exec_s, pred = counted("mesh_executor", lambda: executor.predict_batch(images))
        with torch.inference_mode():
            def single():
                x = torch.from_numpy(net32.preprocess(images.astype(np.float32))[..., None])
                return net32.module(x.to(card))

            single().argmax(-1).cpu()  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            single().argmax(-1).cpu()  # as the executor: host preprocess, labels downloaded
            single_s = time.perf_counter() - t0
            logits = single().cpu().numpy()
    top2 = np.sort(logits, -1)[..., -2:]
    decisive = top2[..., 1] - top2[..., 0] >= DECISIVE * np.abs(logits).max()
    differ = pred != logits.argmax(-1)
    report["executor"] = {"pages": MESH_EXECUTOR_PAGES, "shape": list(images.shape),
                          "ms_mesh": exec_s * 1e3, "ms_single": single_s * 1e3,
                          "label_flips": int(differ.sum()), "decisive_flips": int((differ & decisive).sum())}
    log(f"phase mesh, executor: ParallelPredictor on {images.shape} (float32, TF32 off) in "
        f"{exec_s * 1e3:.1f} ms vs one device {single_s * 1e3:.1f} ms (host preprocess and label "
        f"download included in both); "
        f"labels differ from the one-device argmax on {int(differ.sum())} of {differ.size} pixels, "
        f"{int((differ & decisive).sum())} decisive")
    if pred.shape != differ.shape or (differ & decisive).any():
        raise AssertionError("ParallelPredictor labels differ from the single-device argmax")

    # ---- 4. data-parallel train steps (float32, TF32 off)
    def compact_batch(n, n_padded, shape, channels=1):
        batch = {"image": np.zeros((n_padded,) + shape + (channels,), np.uint8),
                 "binary": np.zeros((n_padded,) + shape, np.uint8),
                 "mask": np.zeros((n_padded,) + shape, np.uint8),
                 "dims": np.zeros((n_padded, 2), np.int32)}
        for i, d in enumerate(prepared_pages.data[:n]):
            h, w = d.image.shape
            batch["image"][i, :h, :w] = d.image[..., None]
            batch["binary"][i, :h, :w] = d.binary
            batch["mask"][i, :h, :w] = layout_labels(i, h, w)
            batch["dims"][i] = (h, w)
        return batch

    step_report = {}
    with backend_flags("mesh: train step", {**NO_TF32, "cudnn.deterministic": True}):
        fcn = FCNSkip(3).to(card)
        fcn.load_state_dict(params_from_jax(variables))
        kw = dict(device_preprocess=Architecture.FCN_SKIP.device_preprocess())
        opt = Optimizers.ADAM.make(1e-3)
        single_step, _ = make_step_fns(fcn, opt, ce_loss, **kw)
        mesh_step, _ = make_step_fns(fcn, opt, ce_loss, mesh=mesh, **kw)
        n_padded = -(-MESH_STEP_PAGES // MESH_SHARDS) * MESH_SHARDS
        host = compact_batch(MESH_STEP_PAGES, n_padded, padded)
        params = dict(fcn.named_parameters())
        on_card = {k: torch.from_numpy(v[:MESH_STEP_PAGES]).to(card) for k, v in host.items()}
        loss_s, grads_s = single_step.value_and_grad(params, {}, on_card)
        _, (loss_m, grads_m) = counted("mesh_step", lambda: mesh_step.value_and_grad(params, {}, host))
        opt_state = opt.init(params)
        sharded = {k: [torch.from_numpy(c).to(card) for c in np.split(v, MESH_SHARDS)]
                   for k, v in host.items()}
        step_ms = {"mesh": cuda_ms(lambda: mesh_step(params, {}, opt_state, sharded), reps=5),
                   "single": cuda_ms(lambda: single_step(params, {}, opt_state, on_card), reps=5)}
        step_peak = peak_mib(lambda: mesh_step(params, {}, opt_state, sharded))
        step_report["fcn_skip"] = {
            "pages": MESH_STEP_PAGES, "padded_to": n_padded, "shape": list(padded),
            "loss_rel": abs(float(loss_m) - float(loss_s)) / abs(float(loss_s)),
            "grad_rel": rel(grads_m, grads_s), "ms_mesh": step_ms["mesh"],
            "ms_single": step_ms["single"], "card_peak_mib": step_peak}

        # mobile_net (BatchNorm averaged over the shards): the card's mesh step
        # against the same mesh step on the CPU
        arch = Architecture("mobile_net")
        bn_shape = tuple(-(-v // arch.stride_factor) * arch.stride_factor for v in (out_h, out_w))
        n_bn = -(-MESH_BN_PAGES // MESH_SHARDS) * MESH_SHARDS
        bn_host = compact_batch(MESH_BN_PAGES, n_bn, bn_shape)
        bn_host["image"] = np.repeat(bn_host["image"], 3, axis=-1)
        start = params_from_jax(init_variables_numpy(arch.model(3), SEED))
        got = {}
        for where, devices in ((DEVICE, [card] * MESH_SHARDS), ("cpu", "cpu")):
            net = arch.model(3)
            net.load_state_dict(start)
            net.to(card if where == DEVICE else "cpu")
            bn_mesh = make_mesh(MESH_SHARDS, devices=devices)
            step, _ = make_step_fns(net, Optimizers.ADAM.make(1e-3), ce_loss, mesh=bn_mesh,
                                    device_preprocess=arch.device_preprocess())
            name = "mesh_step_bn" if where == DEVICE else "mesh_step_bn_cpu"
            _, (loss_value, g, new_s) = counted(name, lambda: step.value_and_grad(
                dict(net.named_parameters()), dict(net.named_buffers()), bn_host, with_state=True))
            got[where] = (float(loss_value), g, new_s)
        (card_loss, card_g, card_s), (cpu_loss, cpu_g, cpu_s) = got[DEVICE], got["cpu"]
        step_report["mobile_net"] = {
            "pages": MESH_BN_PAGES, "padded_to": n_bn, "shape": list(bn_shape),
            "loss_rel": abs(card_loss - cpu_loss) / abs(cpu_loss), "grad_rel": rel(card_g, cpu_g),
            "batch_stats_rel": rel(card_s, cpu_s)}
    report["train_step"] = step_report
    fcn_r, bn_r = step_report["fcn_skip"], step_report["mobile_net"]
    log(f"phase mesh, train step (float32, TF32 off): FCNSkip {MESH_STEP_PAGES} pages padded to "
        f"{n_padded} over {MESH_SHARDS} shards vs one device: loss rel {fcn_r['loss_rel']:.3e}, "
        f"gradients {fcn_r['grad_rel']:.3e} relative in norm; step {fcn_r['ms_mesh']:.3f} ms vs "
        f"{fcn_r['ms_single']:.3f} ms, peak {fcn_r['card_peak_mib']:.1f} MiB; mobile_net "
        f"{MESH_BN_PAGES} pages padded to {n_bn}, card mesh vs CPU mesh: loss rel "
        f"{bn_r['loss_rel']:.3e}, gradients {bn_r['grad_rel']:.3e}, batch_stats {bn_r['batch_stats_rel']:.3e}")
    if fcn_r["loss_rel"] > 1e-5 or fcn_r["grad_rel"] > 1e-3:
        raise AssertionError(f"the data-parallel FCNSkip step disagrees: {fcn_r}")
    if bn_r["loss_rel"] > 1e-5 or bn_r["grad_rel"] > 1e-3 or bn_r["batch_stats_rel"] > 1e-4:
        raise AssertionError(f"the data-parallel mobile_net step disagrees: {bn_r}")

    # ---- 5. Trainer(distributed=True) over a one-process group, versioned
    # checkpoints, then auto_resume
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(work, "mesh_train")
    settings = train_settings._replace(
        n_epoch=1, output_dir=out, distributed=True, checkpoint_backend="orbax", load=None,
        evaluation_data=None, save_best_model_only=False, device=DEVICE)
    distributed.initialize(f"127.0.0.1:{port}", 1, 0, device=DEVICE)
    try:
        reduced = torch.arange(4, dtype=torch.float32, device=card)
        dist.all_reduce(reduced)
        backend = dist.get_backend()
        if backend != ("nccl" if card.type == "cuda" else "gloo") or reduced.tolist() != [0, 1, 2, 3]:
            raise AssertionError(f"all_reduce over {backend} gave {reduced.tolist()}")
        trainer = Trainer(settings)
        if trainer.mesh.devices.size != 1 or trainer.mesh.process_count != 1:
            raise AssertionError(f"distributed mesh {trainer.mesh}")
        first_s, first = counted("mesh_train", trainer.train)
        steps_after_first = OrbaxCheckpointer(os.path.join(out, "model_orbax")).all_steps()
        resumed = Trainer(settings._replace(n_epoch=2, auto_resume=True))
        resume_epoch = resumed._resume_meta and resumed._resume_meta.get("epoch")
        second_s, second = counted("mesh_train_resumed", resumed.train)
        steps = OrbaxCheckpointer(os.path.join(out, "model_orbax")).all_steps()
    finally:
        distributed.shutdown()
    report["trainer"] = {"backend": backend, "pages": len(settings.train_data), "first_s": first_s,
                         "resumed_s": second_s, "losses": first["loss"] + second["loss"],
                         "steps_after_first": steps_after_first, "steps": steps,
                         "resumed_from_epoch": resume_epoch}
    log(f"phase mesh, trainer: distributed.initialize() at world size 1 over {backend}, all_reduce "
        f"on the card; Trainer(distributed=True) 1 epoch of {len(settings.train_data)} pages in "
        f"{first_s:.2f} s, versioned steps {steps_after_first}; auto_resume from epoch "
        f"{resume_epoch} ran epoch 1 in {second_s:.2f} s, steps {steps}; losses "
        f"{[round(v, 5) for v in first['loss'] + second['loss']]}")
    if steps_after_first != [0] or resume_epoch != 0 or steps != [0, 1] or len(second["loss"]) != 1:
        raise AssertionError(f"versioned checkpoints / auto_resume: {report['trainer']}")
    if not np.isfinite(first["loss"] + second["loss"]).all():
        raise AssertionError("non-finite training loss on the mesh")

    for name, count in launches.items():
        if name not in ("mesh_throughput", "throughput_no_mesh") and any(count.values()):
            raise AssertionError(f"{name} launched kernels: {count}")
    log("mesh: " + json.dumps(report))
    return {"report": report, "launches": launches}


@backend_flags("quality")
def phase_quality(work: str):
    """Training quality on the golden corpus: the port's
    ``tools/train_quality.py`` workflow with the recipe of the JAX tool's
    record (``--monitor val_accuracy``, augmentation, up to QUALITY_EPOCHS
    epochs with the trainer's early stopping), train and ``predict --fast
    --high_res_output`` on the card, then the same predict in bf16.  Gates:
    the JAX tool's split, the loss down QUALITY_LOSS_DROP-fold, the held-out
    FgPA and every per-label F1 over their floors, and the trained model's
    bf16 and float32 labels equal on QUALITY_BF16_AGREEMENT of all held-out
    pixels (every pixel counts, not only decisive ones)."""
    import os

    from page_segmentation_tpu_torch.cli.main import main as cli
    from page_segmentation_tpu_torch.core.colors import ColorMap
    from page_segmentation_tpu_torch.core.image_io import imread_rgb
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.tools import train_quality

    t_phase = time.perf_counter()
    root = os.path.join(work, "quality")
    os.makedirs(root)
    args = train_quality.build_parser().parse_args(
        ["--monitor", "val_accuracy", "--n-epoch", str(QUALITY_EPOCHS), "--device", DEVICE])
    # the workflow's train launches no kernel (phase_train holds that), so
    # the count read after it is its predict --fast's
    cuda_cc.launches = cuda_add_one.launches = 0
    record = train_quality.run_workflow(args, root)
    torch.cuda.synchronize()
    launches = {"cc_label": cuda_cc.launches, "add_one": cuda_add_one.launches}
    paths = record.pop("paths")

    bf16_dir = os.path.join(root, "pred_bf16")
    cuda_cc.launches = 0
    t0 = time.perf_counter()
    rc = cli(train_quality.predict_args(paths["model"], paths["held"], bf16_dir, paths["image_map"],
                                        args.target_line_height, DEVICE) + ["--dtype", "bfloat16"])
    bf16_s = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"predict --fast --dtype bfloat16 returned {rc}")
    cmap = ColorMap.load(paths["image_map"])
    same = total = 0
    for page in record["test_pages"]:
        want = cmap.to_labels(imread_rgb(os.path.join(paths["pred"], "color", f"{page}.png")))
        got = cmap.to_labels(imread_rgb(os.path.join(bf16_dir, "color", f"{page}.png")))
        same += int((want == got).sum())
        total += want.size
    agreement = same / total
    f1 = {k: v["f1"] for k, v in record["per_label"].items()}
    report = {**record, "bf16_agreement": agreement, "bf16_pixels": total,
              "bf16_predict_s": bf16_s, "bf16_cc_label_launches": cuda_cc.launches,
              "cc_label_launches": launches["cc_label"],
              "phase_s": time.perf_counter() - t_phase}
    # the record goes out before the gates, so a failed run still shows its numbers
    log("quality: " + json.dumps(report))
    log(f"phase quality: {record['epochs_ran']} epochs in {record['train_seconds']} s; held-out FgPA "
        f"{record['value']}, accuracy {record['accuracy']}, F1 {f1}; bf16 == float32 on "
        f"{agreement:.6f} of {total} pixels; {report['phase_s']:.1f} s")
    if (record["split_seed"], record["test_pages"]) != QUALITY_SPLIT:
        raise AssertionError(f"split {record['split_seed']} {record['test_pages']} is not the JAX "
                             f"tool's {QUALITY_SPLIT}")
    if not record["loss_last"] < record["loss_first"] / QUALITY_LOSS_DROP:
        raise AssertionError(f"loss {record['loss_first']} -> {record['loss_last']}: not down "
                             f"{QUALITY_LOSS_DROP}-fold")
    if record["value"] < QUALITY_FGPA or min(f1.values()) < QUALITY_F1:
        raise AssertionError(f"held-out FgPA {record['value']} (floor {QUALITY_FGPA}), "
                             f"F1 {f1} (floor {QUALITY_F1})")
    if agreement < QUALITY_BF16_AGREEMENT:
        raise AssertionError(f"trained FCNSkip: bf16 vs float32 labels agree on {agreement:.6f} of "
                             f"{total} held-out pixels (floor {QUALITY_BF16_AGREEMENT})")
    if launches["add_one"]:
        raise AssertionError("add_one ran on the quality path")
    return {"report": report, "launches": launches}


def profiled(fn):
    """Run ``fn`` under torch.profiler: (wall µs, µs in which the device ran
    a kernel or a copy, device µs by event name, device event count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end) for e in device):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    by_name = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return wall_us, busy_us, by_name, len(device)


@backend_flags("profile")
def phase_profile(tp, pages, binaries):
    """torch.profiler over one more run of the main path: device time by
    kernel, and the share of the run's wall time in which the device ran
    no kernel and no copy (its idle share)."""

    def run():
        for _ in tp.run(pages, binaries, batch_size=BATCH):
            pass

    wall_us, busy_us, by_name, n_events = profiled(run)
    total_us = sum(by_name.values())
    log(f"phase profile: {N_PAGES} pages in {wall_us / 1e3:.1f} ms under the profiler; device "
        f"busy {busy_us / 1e3:.3f} ms, idle share {1 - busy_us / wall_us:.4f}; "
        f"{n_events} device events, {total_us / 1e3:.3f} ms of device time")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:15]:
        log(f"  {us / 1e3:9.3f} ms {us / max(total_us, 1e-9):7.2%}  {name[:110]}")
    cc = {k: sum(us for name, us in by_name.items() if k in name) for k in CC_PASSES}
    cc_us = sum(cc.values())
    log(f"  cc_label kernels: {cc_us / 1e3:.3f} ms, {cc_us / max(total_us, 1e-9):.2%} of "
        f"device time; " + ", ".join(f"{k} {us / 1e3:.3f} ms" for k, us in cc.items()))


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="also trace one main-path run with torch.profiler")
    profile = parser.parse_args(argv).profile
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from page_segmentation_tpu_torch.inference.pipeline import nearest_index_array
    from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
    from page_segmentation_tpu_torch import native

    t_start = time.perf_counter()
    phase_card()

    t0 = time.perf_counter()
    pages, binaries = synthesize_pages(N_PAGES, *A4, seed=SEED)
    large_ink = synthesize_pages(1, *LARGE_PAGE, seed=SEED + 1, rules=True)[1][0] == 0
    (out_h, out_w), padded = normalized_shapes()
    text_ink = np.zeros((BATCH,) + padded, np.uint8)
    text_ink[:, :out_h, :out_w] = native.gather_ink(
        binaries[:BATCH], nearest_index_array(out_h, A4[0]), nearest_index_array(out_w, A4[1]))
    log(f"phase inputs: {N_PAGES} synthetic A4 pages + one {LARGE_PAGE} page in "
        f"{time.perf_counter() - t0:.2f} s")

    kernel = phase_kernels(text_ink, large_ink)
    state = params_from_jax(init_params_numpy(3, SEED))
    phase_forward(state, native.decimate_u8(pages[:4], HOST_DECIMATE))
    launches, tp = phase_main_path(state, pages, binaries)
    if profile:
        phase_profile(tp, pages, binaries)
    add_one = phase_repro_download()
    library = phase_library(pages, binaries)
    work = tempfile.mkdtemp(prefix="chip_smoke_corpus_")
    try:
        corpus = phase_corpus(pages, binaries, work)
        segment = phase_segment(work)
        options = phase_options(pages, binaries, corpus["model"], work)
        serve = phase_serve(pages, corpus["model"])
        train = phase_train(pages, binaries, work)
        families = phase_families(pages, binaries, work)
        init = phase_init(pages, binaries)
        trainer = train.pop("trainer")
        train_families = phase_train_families(trainer, work)
        mesh = phase_mesh(pages, binaries, corpus["model"], trainer.settings, work)
        quality = phase_quality(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log("entry points: " + json.dumps({
        "corpus_cli_pipeline_pages_per_s": corpus["cli_pages_per_s"],
        "corpus_pallas_pages_per_s": corpus["pallas_pages_per_s"],
        "predict_fast_pages_per_s": corpus["fast_pages_per_s"],
        "serve_pages_per_s": serve["pages_per_s"],
        "serve_client_p50_ms": serve["client_p50_ms"], "serve_client_p99_ms": serve["client_p99_ms"],
        "serve_stats": serve["stats"], "serve_spline_pages_per_s": serve["spline_pages_per_s"],
        "corpus_stages_ms": corpus["stages_ms"], "serve_stages_ms": serve["stages_ms"]}))
    log("segmentation: " + json.dumps({k: v for k, v in segment.items() if k != "launches"}))
    log("predict options: " + json.dumps(options["report"]))
    option_launches = {path: options["launches"][path] for path in
                       ("int8_throughput", "s2d_throughput", "banded", "export")}
    log("training: " + json.dumps({k: v for k, v in train.items() if k != "launches"}))
    log("families: " + json.dumps(families["families"]))
    log("init: " + json.dumps({k: v for k, v in init.items() if k != "launches"}))
    log("training families: " + json.dumps(train_families["families"]))
    family_launches = sum(f["cc_label_launches"] for f in families["families"].values())
    print(json.dumps({"kernels": [{
        "name": "cc_label",
        "route": "cuda",
        "source": "page_segmentation_tpu_torch/csrc/cc_label.cu",
        "replaces": "page_segmentation_tpu/ops/pallas_cc.py:68",
        "also_replaces": "page_segmentation_tpu/ops/pallas_cc.py:129",
        "shape": list(text_ink.shape),
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "device_ms": kernel["device_ms"],
        "pass_ms": kernel["pass_ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cast_ms": kernel["cast_ms"],
        "host_us": kernel["host_us"],
        "launches_by_path": {"throughput": launches, "library": library["launches"],
                             "repro_download": add_one["cc_label_launches"],
                             "predict_pipeline_cli": corpus["cli_launches"],
                             "corpus_pallas": corpus["pallas_launches"],
                             "predict_fast_cli": corpus["fast_launches"],
                             "serve_fused": serve["fused_launches"],
                             "serve_spline": serve["spline_launches"],
                             "train": train["launches"]["cc_label"],
                             "families_throughput": family_launches,
                             "families_library": families["library_launches"],
                             "init": init["launches"]["cc_label"],
                             "families_train": train_families["launches"]["cc_label"],
                             "segment": segment["launches"]["cc_label"],
                             **{k: v["cc_label"] for k, v in option_launches.items()},
                             "mesh_throughput": mesh["launches"]["mesh_throughput"]["cc_label"],
                             "quality": quality["launches"]["cc_label"]},
        "tiled": kernel["tiled"],
    }, {
        "name": "add_one",
        "route": "cuda",
        "source": "page_segmentation_tpu_torch/csrc/add_one.cu",
        "replaces": "tools/repro_pallas_download.py:45",
        "shape": add_one["shape"],
        "launches": add_one["launches"],
        "launches_by_path": {"throughput": 0, "library": 0, "repro_download": add_one["launches"],
                             "predict_pipeline_cli": 0, "corpus_pallas": 0, "predict_fast_cli": 0,
                             "serve_fused": 0, "serve_spline": 0,
                             "train": train["launches"]["add_one"], "families_throughput": 0,
                             "families_library": 0, "init": init["launches"]["add_one"],
                             "families_train": train_families["launches"]["add_one"],
                             "segment": segment["launches"]["add_one"],
                             **{k: v["add_one"] for k, v in option_launches.items()},
                             "mesh_throughput": mesh["launches"]["mesh_throughput"]["add_one"],
                             "quality": quality["launches"]["add_one"]},
        "max_abs_err": add_one["max_abs_err"],
        "ms": add_one["ms"],
        "plain_ms": add_one["plain_ms"],
        "bound_ms": add_one["bound_ms"],
        "bound_by": "bytes",
        "library_ms": add_one["library_ms"],
        "graph_ms": {"kernel": add_one["graph_ms"], "plain": add_one["plain_graph_ms"],
                     "library": add_one["library_graph_ms"]},
        "host_us": add_one["host_us"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
