"""A collection through ``ThroughputPredictor.run``, the path that
``predict --pipeline`` and ``RawCorpusPredictor`` share.

Set-up makes the pool of pages and the weights from the seed (for a
BatchNorm family the reference sets the statistics from one batch of the
pool), builds the predictor as the configuration states it and starts one
endless stream over the pool: batch k is pool rows ``k * batch mod pool``,
a view, so nothing is copied per batch and nothing drains between passes.
The first ``warmup_batches`` yields warm every shape and build every
kernel; the window opens at the last of them and closes at the first yield
at or past ``--seconds``, so a stall across the deadline stays inside it.
``pages_per_s`` is the pages yielded inside over the time between those
two yields.

The check: one page of every yielded batch, drawn from the seed, against
the reference's answer for the same pool page (``reference/pipeline.py``
``page_mismatch``: the share of pixels answered otherwise where the
reference's answer is decisive); the number is its mean over the pages.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import tracing, weights
from benchmark.reference import models
from benchmark.reference import pipeline as ref
from benchmark.traffic import synthesize_pages


class Stream:
    """An endless array of pages over a pool: row k is pool row k mod n.
    Slices must cover whole batches that divide the pool."""

    def __init__(self, pool: np.ndarray, length: int):
        self.pool = pool
        self.shape = (length,) + pool.shape[1:]

    def __getitem__(self, s: slice) -> np.ndarray:
        start = s.start % len(self.pool)
        return self.pool[start:start + (s.stop - s.start)]


def reference_config(cell) -> dict:
    cfg, mix = cell.config, cell.traffic
    return {**cfg, **cfg["predict"], "page_shape": mix["page_shape"],
            "scale": cfg["target_line_height"] / mix["line_height"]}


def seeded_state(cfg: dict, pages: np.ndarray, seed: int, device) -> dict:
    """The benchmark's weights for ``cfg``.  With ``calibration_pages``, the
    reference's own forward over the first pages of the pool sets every
    BatchNorm's statistics, then shifts the logits' biases so that each
    class's mean logit over those pages is the same: otherwise a class's
    offset alone wins every pixel of some seeds' random models, whose
    answer then no precision can change."""
    state = weights.make_weights(models.leaves_of(cfg["architecture"], cfg["n_classes"]),
                                 seed, device)
    n = cfg.get("calibration_pages", 0)
    if n:
        predict = ref.Predict(cfg, state, device)
        dec = ref.decimate(torch.as_tensor(pages[:n]).to(device), cfg["host_decimate"])
        x = ref.model_input(dec, predict.out_shape, predict.pad_shape, cfg["preprocess"])
        with ref.float32_exact(), torch.no_grad():
            models.calibrate(cfg["architecture"], state, x)
            mean = models.forward_of(cfg["architecture"])(state, x).mean(dim=(0, 2, 3))
            state["logits.bias"] -= mean - mean.mean()
    return state


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """Per-tensor scaled rounding to float8 e4m3 and back (the control's
    precision: the step below bfloat16)."""
    scale = t.abs().amax().clamp_min(1e-12) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def build_predictor(cfg: dict, state: dict, device, int8: bool = False):
    from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
    from page_segmentation_tpu_torch.models.registry import Architecture

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg["dtype"]]
    module = Architecture(cfg["architecture"]).model(cfg["n_classes"], dtype=dtype)
    return ThroughputPredictor(
        module, {k: v.clone() for k, v in state.items()}, np.asarray(cfg["palette"], np.uint8),
        tuple(cfg["page_shape"]), cfg["scale"], host_decimate=cfg["host_decimate"],
        stride_factor=cfg["stride_factor"], compute_dtype=dtype, download=cfg["download"],
        cc_vote=cfg["cc_vote"], preprocess_mode=cfg["preprocess"], int8=int8, device=device)


def run(ctx) -> None:
    cell, device = ctx.cell, ctx.device
    cfg, mix = reference_config(cell), cell.traffic
    batch, pool_n = cfg["batch"], mix["pool_pages"]
    if pool_n % batch:
        raise ValueError(f"pool of {pool_n} pages is not whole batches of {batch}")
    pages, binaries = synthesize_pages(pool_n, mix["page_shape"], ctx.seed, mix["line_height"],
                                       mix["figure_every"], device=device)
    state = seeded_state(cfg, pages, ctx.seed, device)
    control = cfg["control"] if ctx.control else None
    sample_rng = np.random.default_rng([ctx.seed, 1])
    kept = []  # (pool index, trio of that page) of one page per counted batch

    if control == "reference_fp8":
        # the control in the program's place: no window, the same sample
        ctx.window_start()
        ctx.window_closed()
        picks = sample_rng.integers(0, pool_n, size=mix["control_pages"])
        low = ref.Predict(cfg, state, device, cast=fp8_cast).trios(pages[picks], binaries[picks])
        kept = list(zip(picks.tolist(), low))
    else:
        tp = build_predictor(cfg, state, device, int8=control == "program_int8")
        spans = tracing.Spans() if ctx.trace else None
        window = tracing.Window(ctx, ranges=("cc_vote",))
        if spans is not None:
            from page_segmentation_tpu_torch.ops import cuda_cc

            ctx.spans = spans
            spans.wrap(tp, "prep_batch", "prep_batch")
            spans.wrap(tp, "_dispatch", "dispatch")
            spans.wrap(tp, "_download_finish", "download_finish")
            spans.wrap(cuda_cc, "cc_vote_batch", "cc_vote")
        stream = tp.run(Stream(pages, pool_n * 10 ** 6), Stream(binaries, pool_n * 10 ** 6),
                        batch_size=batch, depth=cfg["depth"])
        index = 0
        for _ in range(mix["warmup_batches"]):
            next(stream)
            index += 1
        t0 = ctx.window_start()
        deadline, t_last, counted = t0 + ctx.seconds, t0, 0
        for trio in stream:
            t_last = time.perf_counter()
            j = int(sample_rng.integers(0, batch))
            kept.append(((index * batch + j) % pool_n, tuple(a[j].copy() for a in trio)))
            index += 1
            counted += batch
            window.tick(unit_done=True)
            if t_last >= deadline:
                break
        stream.close()
        window.close()
        ctx.window_s = t_last - t0
        ctx.counts["pages"] = counted
        ctx.attempted = counted
        ctx.window_closed()
        ctx.values["flop_per_batch"] = batch * flop_per_page(cfg)
        ctx.values["pad_shape"] = tp.fused.padded_shape
        ctx.values["batch"] = batch
        del tp, stream
        if device == "cuda":
            torch.cuda.empty_cache()

    # the reference, once per pool page that the sample holds
    wanted = sorted({p for p, _ in kept})
    truth = dict(zip(wanted, ref.Predict(cfg, state, device).truths(pages[wanted], binaries[wanted])))
    palette = np.asarray(cfg["palette"], np.uint8)
    ctx.counts["compared_pages"] = len(kept)
    ref.check_mismatch(ctx, [(got, truth[p]) for p, got in kept], palette)


def flop_per_page(cfg: dict) -> float:
    """The forward's FLOPs of one page at its padded shape."""
    from benchmark.arith import forward_flops

    channels = 1 if cfg["preprocess"] == "gray" else 3
    pad = ref.Predict(cfg, {}, "meta").pad_shape
    return forward_flops(cfg["architecture"], cfg["n_classes"], (1, channels) + pad)
