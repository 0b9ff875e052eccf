"""The train and eval steps, on one device or data-parallel over a mesh.

Counterpart of ``page_segmentation_tpu/train/steps.py`` ``make_step_fns``
and ``make_forward_fn``.  A step is forward, loss, backward, optimizer
update and metrics, run eagerly (the JAX package compiles it into one
program).  Batches are dicts in one of two layouts:

* float: ``image`` (N, H, W, C) float32, already normalized; ``mask``
  (N, H, W) int32; ``binary`` (N, H, W) uint8 (1 = ink); ``weights``
  (N, H, W) float32, 0 on bucket padding;
* compact: ``image`` uint8 raw pixels, ``mask`` uint8 and ``dims`` (N, 2)
  int32, the valid rows and columns of each page.  The step normalizes the
  pixels, builds the weights on the device and zeroes the image on the
  padding again, so both layouts feed the same activations.

Either may carry ``class_weights`` (n_classes,): each pixel's loss then
scales by its true class's weight (``loss_weights``).  The monitored
``loss`` stays the plain cross-entropy, with the weighted objective beside
it as ``loss_weighted``.

``params`` are the module's parameters as a dict of tensors (its
``state_dict`` layout), ``model_state`` its BatchNorm buffers in the same
layout ({} for the families without BatchNorm) and ``opt_state`` the
``train/optim.py`` state; the train step returns new ones and leaves its
inputs as they were.

The train step runs the module in training mode, as the JAX step applies
the flax module with ``train=True`` and ``mutable=["batch_stats"]``:
BatchNorm normalizes with the batch's statistics and the step collects the
running statistics each BatchNorm computed (``models/layers.py``), and
``dropout_rng`` (an ``ops/prng.py`` key, the JAX step's ``dropout_rng``)
drives the dropout of the models that have it, drawing JAX's masks.  None
draws no dropout.  The eval step runs in eval mode on the running statistics.
Parameters that the loss does not reach (EfficientNet's dead tail) get zero
gradients, as ``jax.grad`` gives them.  With the span recorder on
(``train/profiling.py``) forward and backward run under ``ps.fwd_bwd`` and
the optimizer's update with the new parameters under ``ps.optim``.

With a ``mesh`` the batch is split over its ``data`` axis (a dict of lists,
one piece per device, from ``parallel/mesh.py`` ``shard_batch`` or
``parallel/distributed.py`` ``global_batch``; a host batch is split here).
Each shard runs forward and backward on its own device with that device's
copy of the parameters (``torch.func.functional_call`` over per-device
dicts: the step already threads the parameters as a dict), and the shards
reduce as the JAX ``shard_map`` step does: each shard's loss is scaled by
its share of the global weight mass, so the summed gradient is the
single-device one and pure-padding shards add nothing; each shard draws its
dropout under ``fold_in(dropout_rng, shard)``, the global shard index, as
the JAX step folds in ``axis_index``; BatchNorm statistics
are averaged over the shards; the metrics are pixel-weighted (``loss``,
``accuracy``) or per-valid-page means (the others); ``loss`` is the reduced
monitored loss.  The sums run in two ``parallel/mesh.py`` ``psum`` calls a
step (the weight mass before the backward, then one buffer of gradients,
statistics and metrics), each one ``all_reduce`` across processes.  The
``skip_nonfinite`` verdict is taken on the reduced gradients, the optimizer
runs once, on the first device, and the next step copies the new
parameters to every shard.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch.func import functional_call

from ..models.layers import BatchNorm
from ..ops.prng import fold_in
from . import metrics as M
from .optim import map_tree
from .profiling import span


def add_updates(params, updates):
    """``params + updates``, every tensor in one call."""
    keys = list(params)
    return dict(zip(keys, torch._foreach_add([params[k].detach() for k in keys],
                                             [updates[k] for k in keys])))


def make_step_fns(
    module,
    optimizer,
    loss_fn: Callable,
    mesh=None,
    data_axis: str = "data",
    remat: bool = False,
    device_preprocess: Optional[Callable] = None,
    skip_nonfinite: bool = False,
    class_weights=None,
):
    """(train_step, eval_step).

    train_step(params, model_state, opt_state, batch, dropout_rng=None)
        -> (params, model_state, opt_state, metrics)
    eval_step(params, model_state, batch) -> metrics

    Metrics are 0-d tensors on the batch's device.  ``skip_nonfinite``: a
    step whose loss or gradients are not finite keeps the params, BatchNorm
    statistics and optimizer state it was given and reports ``nonfinite`` =
    1.  ``remat`` recomputes the forward in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations; the
    recomputation draws the same dropout mask.
    ``train_step.value_and_grad(params, model_state, batch,
    dropout_rng=None, with_state=False)`` gives the optimized loss and the
    gradients of one batch (and, ``with_state``, the new BatchNorm
    statistics).
    """
    n_cw = len(class_weights) if class_weights is not None else 0
    cw_default = (torch.as_tensor(class_weights, dtype=torch.float32)
                  if class_weights is not None else None)

    def class_weight_map(cw, mask):
        cw = cw.to(device=mask.device, dtype=torch.float32)
        return cw[mask.long().clamp(0, n_cw - 1)] * (mask.long() < n_cw)

    def unpack(batch):
        if "dims" not in batch:
            if n_cw and "loss_weights" not in batch:
                batch = dict(batch)
                cw = batch.pop("class_weights", cw_default)
                lw = class_weight_map(cw, batch["mask"])
                batch["loss_weights"] = batch["weights"] * lw if "weights" in batch else lw
            return batch
        image = batch["image"]
        x = image.to(torch.float32)
        if image.dtype == torch.uint8:
            x = device_preprocess(x) if device_preprocess else x / 255.0
        n, h, w = image.shape[:3]
        dims = batch["dims"].to(image.device)
        rows = torch.arange(h, device=image.device).view(1, h, 1)
        cols = torch.arange(w, device=image.device).view(1, 1, w)
        weights = ((rows < dims[:, 0, None, None]) & (cols < dims[:, 1, None, None])).to(torch.float32)
        # the float layout pads after normalizing, so its padding is 0
        x = x * weights[..., None]
        out = {"image": x, "mask": batch["mask"].to(torch.int32), "binary": batch["binary"],
               "weights": weights}
        if n_cw:
            cw = batch.get("class_weights")
            out["loss_weights"] = weights * class_weight_map(cw if cw is not None else cw_default,
                                                             out["mask"])
        return out

    def compute_metrics(batch, logits):
        # the monitored loss is the plain objective even with class weights
        w = batch.get("weights")
        return {
            "loss": loss_fn(batch["mask"], logits, weights=w),
            "accuracy": M.accuracy(batch["mask"], logits, weights=w),
            "jacard_coef": M.jacard_coef(batch["mask"], logits, weights=w).mean(),
            "dice_coef": M.dice_coef(batch["mask"], logits, weights=w).mean(),
            "fgpa": M.fgpa(batch["mask"], logits, batch["binary"], weights=w),
        }

    batch_norms = [(name, m) for name, m in module.named_modules() if isinstance(m, BatchNorm)]

    def forward(params, model_state, image, dropout_rng):
        # the mask is a function of the key: a recomputation (remat) draws it again
        return functional_call(module, {**params, **model_state}, (image,),
                               {"dropout_rng": dropout_rng})

    def collect_stats():
        """The running statistics each BatchNorm computed in the forward."""
        new_state = {}
        for name, bn in batch_norms:
            new_state[f"{name}.mean"], new_state[f"{name}.var"] = bn.updated_stats
            bn.updated_stats = None
        return new_state

    def grads_of(params, model_state, batch, dropout_rng, scale=None):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        args = (leaves, model_state, batch["image"], dropout_rng)
        module.train()
        try:
            with span("ps.fwd_bwd"):
                if remat:
                    logits = torch.utils.checkpoint.checkpoint(forward, *args, use_reentrant=False)
                else:
                    logits = forward(*args)
                weights = batch.get("loss_weights", batch.get("weights"))
                loss_value = loss_fn(batch["mask"], logits, weights=weights)
                if scale is not None:
                    loss_value = loss_value * scale
                grads = torch.autograd.grad(loss_value, list(leaves.values()), allow_unused=True,
                                            materialize_grads=True)
        finally:
            module.eval()
        return loss_value.detach(), logits.detach(), dict(zip(leaves, grads)), collect_stats()

    def value_and_grad(params, model_state, batch, dropout_rng=None, with_state=False):
        loss_value, _, grads, new_state = grads_of(params, model_state, unpack(batch), dropout_rng)
        return (loss_value, grads, new_state) if with_state else (loss_value, grads)

    def train_step(params, model_state, opt_state, batch, dropout_rng=None):
        batch = unpack(batch)
        loss_value, logits, grads, new_state = grads_of(params, model_state, batch, dropout_rng)
        with torch.no_grad():
            with span("ps.optim"):
                updates, new_opt_state = optimizer.update(grads, opt_state, params)
                new_params = add_updates(params, updates)
            step_metrics = compute_metrics(batch, logits)
            if skip_nonfinite:
                finite = torch.isfinite(loss_value)
                for g in grads.values():
                    finite = finite & torch.isfinite(g).all()

                def keep(new, old):
                    return torch.where(finite, new, old)

                new_params = {k: keep(v, params[k].detach()) for k, v in new_params.items()}
                new_state = {k: keep(v, model_state[k]) for k, v in new_state.items()}
                new_opt_state = map_tree(keep, new_opt_state, opt_state)
                step_metrics["nonfinite"] = 1.0 - finite.to(torch.float32)
            if n_cw:
                step_metrics["loss_weighted"] = loss_value
            else:
                step_metrics["loss"] = loss_value
        return new_params, new_state, new_opt_state, step_metrics

    def eval_step(params, model_state, batch):
        module.eval()
        with torch.no_grad():
            batch = unpack(batch)
            logits = functional_call(module, {**params, **model_state}, (batch["image"],))
            return compute_metrics(batch, logits)

    if mesh is None:
        train_step.value_and_grad = value_and_grad
        return train_step, eval_step

    from ..parallel.mesh import psum, shard_batch

    n_shards = mesh.shape[data_axis]  # the axis across every process
    shard_offset = mesh.process_index * len(mesh.axis_devices(data_axis))
    pixel_weighted = ("loss", "accuracy")

    def shards_of(batch):
        """One unpacked batch dict per local shard."""
        if not isinstance(next(iter(batch.values())), (list, tuple)):
            batch = shard_batch(mesh, batch, data_axis)
        n = len(next(iter(batch.values())))
        return [unpack({k: v[i] for k, v in batch.items()}) for i in range(n)]

    def on(tree, device):
        return {k: v.detach().to(device, non_blocking=True) for k, v in tree.items()}

    def weight_shares(shards):
        """Each shard's fraction of the global weight mass."""
        masses = [b.get("loss_weights", b.get("weights")) for b in shards]
        if masses[0] is None:
            return [1.0 / n_shards] * len(shards)
        sums = [w.to(torch.float32).sum() for w in masses]
        total = psum(mesh, [[t] for t in sums])[0].clamp_min(1.0)
        return [t / total.to(t.device) for t in sums]

    def shard_rng(dropout_rng, index):
        """The shard's dropout key: the JAX step's ``fold_in(dropout_rng,
        axis_index)``."""
        return None if dropout_rng is None else fold_in(dropout_rng, shard_offset + index)

    def reduce(shards, metrics, tensors=()):
        """The reduced metrics and the shard-summed ``tensors`` (one list
        per shard), from one psum."""
        keys = list(metrics[0])
        per_shard = []
        for b, m, extra in zip(shards, metrics, tensors or [()] * len(shards)):
            w = b.get("weights")
            if w is None:
                weighted = [m[k] for k in keys]
            else:
                wsum = w.to(torch.float32).sum()
                pages = M.page_validity(w).sum()
                weighted = [m[k] * (wsum if k in pixel_weighted else pages) for k in keys]
                weighted += [wsum, pages]
            per_shard.append([t.reshape(1) for t in weighted] + list(extra))
        summed = psum(mesh, per_shard)
        if shards[0].get("weights") is None:
            reduced = {k: summed[j][0] / n_shards for j, k in enumerate(keys)}
            rest = summed[len(keys):]
        else:
            total_w = summed[len(keys)][0].clamp_min(1.0)
            total_p = summed[len(keys) + 1][0].clamp_min(1.0)
            reduced = {k: summed[j][0] / (total_w if k in pixel_weighted else total_p)
                       for j, k in enumerate(keys)}
            rest = summed[len(keys) + 2:]
        return reduced, rest

    def mesh_grads(params, model_state, batch, dropout_rng):
        """(reduced metrics, global loss, summed gradients, mean statistics)."""
        shards = shards_of(batch)
        shares = weight_shares(shards)
        losses, metrics, tensors = [], [], []
        for i, b in enumerate(shards):
            device = b["image"].device
            loss_i, logits, grads, stats = grads_of(
                on(params, device), on(model_state, device), b,
                shard_rng(dropout_rng, i), scale=shares[i])
            with torch.no_grad():
                metrics.append(compute_metrics(b, logits))
            losses.append(loss_i)
            tensors.append([loss_i.reshape(1)] + list(grads.values()) + list(stats.values()))
        reduced, summed = reduce(shards, metrics, tensors)
        home = next(iter(params.values())).device
        grad_names = list(grads)
        grads = {k: t.to(home) for k, t in zip(grad_names, summed[1 : 1 + len(grad_names)])}
        stats = {k: (t / n_shards).to(home)
                 for k, t in zip(stats, summed[1 + len(grad_names):])}
        finite = torch.stack([torch.isfinite(t).all() for t in losses]).all().to(home)
        return reduced, summed[0][0].to(home), grads, stats, finite

    def mesh_value_and_grad(params, model_state, batch, dropout_rng=None, with_state=False):
        _, loss_value, grads, stats, _ = mesh_grads(params, model_state, batch, dropout_rng)
        return (loss_value, grads, stats) if with_state else (loss_value, grads)

    def mesh_train_step(params, model_state, opt_state, batch, dropout_rng=None):
        step_metrics, _, grads, new_state, finite = mesh_grads(
            params, model_state, batch, dropout_rng)
        with torch.no_grad():
            with span("ps.optim"):
                updates, new_opt_state = optimizer.update(grads, opt_state, params)
                new_params = add_updates(params, updates)
            if skip_nonfinite:
                for g in grads.values():
                    finite = finite & torch.isfinite(g).all()

                def keep(new, old):
                    return torch.where(finite, new, old)

                new_params = {k: keep(v, params[k].detach()) for k, v in new_params.items()}
                new_state = {k: keep(v, model_state[k]) for k, v in new_state.items()}
                new_opt_state = map_tree(keep, new_opt_state, opt_state)
                step_metrics["nonfinite"] = 1.0 - finite.to(torch.float32)
        return new_params, new_state, new_opt_state, step_metrics

    def mesh_eval_step(params, model_state, batch):
        module.eval()
        with torch.no_grad():
            shards = shards_of(batch)
            metrics = []
            for b in shards:
                device = b["image"].device
                logits = functional_call(module, {**on(params, device), **on(model_state, device)},
                                         (b["image"],))
                metrics.append(compute_metrics(b, logits))
            return reduce(shards, metrics)[0]

    mesh_train_step.value_and_grad = mesh_value_and_grad
    return mesh_train_step, mesh_eval_step


def make_forward_fn(module, mesh=None, data_axis: str = "data"):
    """forward(variables, image) -> logits, in inference mode: data-parallel
    over ``mesh``'s ``data_axis`` when given (``image`` and the logits are
    then lists of per-device shards); used by the parallel predict executor.
    ``variables`` is a dict in the module's ``state_dict`` layout, or None
    for the module's own weights (each device runs its copy of the module,
    ``parallel/mesh.py`` ``replicas_of``)."""
    from ..parallel.mesh import replicas_of

    def run(variables, x):
        if variables is None:
            return replicas_of(module).on(x.device)(x)
        weights = {k: v.to(x.device, non_blocking=True) for k, v in variables.items()}
        return functional_call(module, weights, (x,))

    @torch.inference_mode()
    def forward(variables, image):
        module.eval()
        if mesh is None:
            return run(variables, image)
        return [run(variables, shard) for shard in image]

    return forward
