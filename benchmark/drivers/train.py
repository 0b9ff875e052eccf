"""Training through ``Trainer.train``, the path of the ``train`` command.

Set-up makes the pool of pages and their class masks from the seed, loads
them as the command's loader does (``DatasetLoader`` in training mode:
scaled to the target line height, masks resized to match), held in memory
as ``SingleData``, and lists them over and over in one epoch longer than
the window, so no epoch end (its means, validation, checkpoint) falls
inside.  The settings are the ``train`` command's own: its parser's
defaults with the cell's architecture, batch and seed, mapped to
``TrainSettings`` by the command's ``train_settings``; they have to be the
step the reference defines (Adam at 1e-4 after clipnorm 1.0, float32) and
the configuration's ``train`` block where it states one.  The model starts
from the trainer's own fresh weights for the seed and its dropout draws
from the trainer's per-epoch keys.

The driver wraps the trainer's step function: it counts steps, opens the
window after ``warmup_steps`` (a device sync: set-up ends there), and at
the first step launched at or past ``--seconds`` syncs once more, closes
the window and asks the trainer to stop (``Trainer.request_stop``: read on
the host between steps, no tensor touched).  Nothing else syncs inside.
``pages_per_s`` is the pages of the steps launched inside over the time
from the first sync to the last.

The check: ``check_steps`` consecutive steps of the window, the first drawn
from the seed among its first ``check_within_steps``, each keeping the
weights, Adam state, batch and dropout key that went in and the Adam state
that came out, and the weights the step after the last took in.  Two
numbers, each the largest over the kept steps:

* ``grad_tf32_ratio``: the gradient a step fed to Adam, ``(mu_after - b1
  mu_before) / (1 - b1)``, against the reference's clipped float32 gradient
  of the same inputs (``reference/train.py``), as one vector over all
  tensors: its relative L2 error over the same error of the reference run
  with TF32 on, the rounding the configuration states (the float32 floor
  where no TF32 exists).  A gradient sums millions of pixels' terms that
  cancel by a share that changes from step to step and amplifies any
  rounding alike, so the error alone swings 30x over the steps of one run,
  and TF32's and bf16's overlap; over TF32's own error it does not, but on
  a step where TF32 itself misses by most (max-pool choices flip) a step in
  bf16 can read low, hence the largest over several steps (``PERF.md``
  section 2).
* ``update_rel_err``: the weights' change from a step's input to the next
  step's, against Adam's change (``reference/train.py`` ``adam_step``) from
  the kept weights and Adam state with the gradient the step fed to Adam,
  per tensor, the worst: the optimizer's moments, bias corrections and
  learning rate, the new weights and their copy into the module.  Weights
  that never change read 1.

The per-step numbers and the loss's relative error go to standard error.
The control (``program_bf16``) runs the same steps under bf16 autocast.
"""
from __future__ import annotations

import contextlib
import math
import os
import shutil
import sys
import time

import numpy as np
import torch

from benchmark import tracing, train_arith
from benchmark.reference import train as ref
from benchmark.traffic import layout_labels, synthesize_pages


def train_args(cell, seed: int, device, output: str):
    """The ``train`` command's arguments: its own defaults but the cell's
    architecture, batch, page scale and seed, one epoch."""
    from page_segmentation_tpu_torch.cli.main import build_parser

    return build_parser().parse_args([
        "train", "--output", output, "--n_epoch", "1", "--architecture",
        cell.config["architecture"], "--batch_size", str(int(cell.workload["batch"])),
        "--seed", str(seed), "--target_line_height", str(cell.config["target_line_height"]),
        "--device", "cuda" if device == "cuda" else "cpu"])


def make_pool(cell, args, seed: int, device):
    """The pool's pages and class masks, loaded as the ``train`` command's
    loader loads a dataset (scaled to the target line height, the masks
    resized to match): a list of ``SingleData`` and the color map."""
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.data.dataset import SingleData
    from page_segmentation_tpu_torch.data.loader import DatasetLoader

    mix = cell.traffic
    shape, lh, every = mix["page_shape"], mix["line_height"], mix["figure_every"]
    pages, binaries = synthesize_pages(mix["pool_pages"], shape, seed, lh, every, device=device)
    masks = {i: layout_labels(i, shape, lh, every) for i in range(every)}  # one per layout
    entries = [SingleData(image=pages[i], binary=binaries[i], mask=masks[i % every],
                          line_height_px=lh) for i in range(len(pages))]
    loader = DatasetLoader(args.target_line_height, DEFAULT_IMAGE_MAP, max_width=args.max_width,
                           resize_backend=args.resize_backend)
    return loader.load_data(entries).data, DEFAULT_IMAGE_MAP


def build_trainer(cell, args, train_data):
    """``Trainer`` with the ``TrainSettings`` that ``train`` builds from ``args``."""
    from page_segmentation_tpu_torch.cli.main import train_settings
    from page_segmentation_tpu_torch.train.trainer import Trainer

    settings = train_settings(args, args.n_classes or cell.config["n_classes"], args.n_epoch,
                              train_data, None, None)
    ran = {"optimizer": settings.optimizer.value, "l_rate": settings.l_rate,
           "clipnorm": settings.optimizer_norm_clip_value if settings.optimizer_norm_clipping
           else None, "dtype": settings.compute_dtype}
    wanted = {"optimizer": ref.OPTIMIZER, "l_rate": ref.LR, "clipnorm": ref.CLIPNORM,
              "dtype": ref.DTYPE}
    stated = {k: v for k, v in cell.config.get("train", {}).items() if k in wanted}
    if ran != wanted or {**ran, **stated} != ran:
        raise ValueError(f"the train command runs {ran}; the reference is {wanted}, "
                         f"the configuration states {stated}")
    return Trainer(settings)


class Stepper:
    """Takes the trainer's step function's place: counts steps, opens and
    closes the window, keeps the checked steps and asks the trainer to stop."""

    def __init__(self, ctx, trainer, warmup: int, first_checked: int, n_checked: int,
                 control: bool):
        from page_segmentation_tpu_torch.train import profiling

        self.profiling = profiling
        self.ctx, self.trainer = ctx, trainer
        self.inner = trainer._train_step
        self.warmup, self.first_checked = warmup, warmup + first_checked
        self.n_checked = n_checked
        self.control = control
        self.steps = 0
        self.kept = []
        self.t_end = None
        self.window = None
        self.cuda = ctx.device == "cuda"
        trainer._train_step = self

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __call__(self, params, model_state, opt_state, batch, dropout_rng=None):
        i = self.steps - self.first_checked
        if 0 <= i <= self.n_checked:
            # the weights each checked step took in, and the step after the
            # last: what the step before left in the module
            kept = {"params": {k: v.detach().clone() for k, v in params.items()}}
            if i < self.n_checked:
                kept.update(adam={"count": opt_state["base_count"], **opt_state["base"]},
                            batch=batch, key=dropout_rng)
            self.kept.append(kept)
        autocast = (torch.autocast(self.ctx.device, dtype=torch.bfloat16) if self.control
                    else contextlib.nullcontext())
        with autocast:
            out = self.inner(params, model_state, opt_state, batch, dropout_rng)
        if 0 <= i < self.n_checked:
            self.kept[i].update(mu_after=out[2]["base"]["mu"], loss=out[3]["loss"])
        self.steps += 1
        self._after_step()
        return out

    def _after_step(self):
        ctx, profiling = self.ctx, self.profiling
        if self.steps == self.warmup:
            self._sync()
            self.t0 = ctx.window_start()
            self.deadline = self.t0 + ctx.seconds
            if ctx.trace:
                profiling.enable_spans()
            return
        if self.steps < self.warmup or self.t_end is not None:
            return
        self.window.tick(unit_done=True)
        if (time.perf_counter() >= self.deadline
                and self.steps > self.first_checked + self.n_checked):
            ctx.window_closed()  # syncs, then reads the peak
            self.t_end = time.perf_counter()
            self.window.close()
            if ctx.trace:
                profiling.disable_spans()
            self.trainer.request_stop()


def _program_spans():
    """The program's spans as the benchmark's ``Spans`` records, and its
    counters."""
    from page_segmentation_tpu_torch.train import profiling

    spans = tracing.Spans()
    for s in profiling.spans():
        spans.add(s.name, s.start, s.end)
    return spans, profiling.counters()


def run(ctx) -> None:
    from page_segmentation_tpu_torch.data.dataset import Dataset
    from page_segmentation_tpu_torch.train.trainer import Trainer

    if not hasattr(Trainer, "request_stop"):
        raise RuntimeError("this program's Trainer has no request_stop(): the window cannot "
                           "end train() without a device sync on every step")
    cell, device, mix = ctx.cell, ctx.device, ctx.cell.traffic
    batch, warmup = int(cell.workload["batch"]), int(mix["warmup_steps"])
    if mix["pool_pages"] % batch:
        raise ValueError(f"pool of {mix['pool_pages']} pages is not whole batches of {batch}")
    output = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_cache",
                          "train", f"{os.getpid()}")
    args = train_args(cell, ctx.seed, device, output)
    pool, color_map = make_pool(cell, args, ctx.seed, device)
    # one epoch longer than the window at any rate up to epoch_pages_per_s
    wanted = warmup * batch + mix["epoch_pages_per_s"] * ctx.seconds
    repeats = max(2, math.ceil(wanted / len(pool)))
    trainer = build_trainer(cell, args, Dataset(pool * repeats, color_map))
    rng = np.random.default_rng([ctx.seed, 2])
    stepper = Stepper(ctx, trainer, warmup, int(rng.integers(0, mix["check_within_steps"])),
                      int(mix["check_steps"]), control=ctx.control)
    stepper.window = tracing.Window(ctx, ranges=("ps.optim",))
    try:
        trainer.train()
    finally:
        shutil.rmtree(output, ignore_errors=True)
    if stepper.t_end is None:
        raise RuntimeError("the epoch ended inside the window: raise the mix's epoch_pages_per_s")
    steps = stepper.steps - warmup
    ctx.window_s = stepper.t_end - stepper.t0
    ctx.counts["pages"] = steps * batch
    ctx.counts["steps"] = steps
    ctx.attempted = steps
    if ctx.trace:
        ctx.spans, counters = _program_spans()
        if "ps.dropout_bytes" in counters:
            ctx.values["dropout_bytes_per_step"] = counters["ps.dropout_bytes"] / steps
    kept = stepper.kept
    image = kept[0]["batch"]["image"]
    ctx.values["batch"] = batch
    ctx.values["pad_shape"] = tuple(image.shape[1:3])
    ctx.values["flop_per_step"] = train_arith.step_flops(
        cell.config["architecture"], cell.config["n_classes"],
        (batch, image.shape[3]) + tuple(image.shape[1:3]))
    del trainer, stepper
    if device == "cuda":
        torch.cuda.empty_cache()
    check(ctx, cell.config["architecture"], kept)


def check(ctx, architecture: str, kept: list) -> None:
    """The kept steps against the reference: ``grad_tf32_ratio`` and
    ``update_rel_err``, each the largest over the steps; each step's numbers,
    its worst tensors and its loss's relative error go to standard error."""
    ratios, updates = [], []
    for step, after in zip(kept, kept[1:]):
        key = None if step["key"] is None else (int(step["key"][0]), int(step["key"][1]))
        got = {k: ref.adam_input(step["adam"]["mu"][k], step["mu_after"][k])
               for k in step["mu_after"]}
        error, tf32, want, loss = ref.gradient_check(got, architecture, step["params"],
                                                     step["batch"], key)
        adam = {"count": int(step["adam"]["count"]), "mu": step["adam"]["mu"],
                "nu": step["adam"]["nu"]}
        ratios.append(error / max(tf32, ref.FLOAT32_SCALE))
        updates.append(ref.update_error(step["params"], after["params"], got, adam))
        errors = {k: ref.relative_error(got[k], want[k]) for k in want}
        worst = sorted(errors, key=errors.get, reverse=True)
        print(f"step {adam['count'] + 1}: grad_tf32_ratio {ratios[-1]:.3e} (grad_rel_err "
              f"{error:.3e}, the reference in TF32 {tf32:.3e}); update_rel_err "
              f"{updates[-1]:.3e}; per tensor, largest: "
              + ", ".join(f"{k} {errors[k]:.3e}" for k in worst[:3])
              + f"; loss_rel_err {abs(float(step['loss']) - float(loss)) / abs(float(loss)):.3e}",
              file=sys.stderr)
    ctx.check("grad_tf32_ratio", max(ratios))
    ctx.check("update_rel_err", max(updates))
