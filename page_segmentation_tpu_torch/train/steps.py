"""The train and eval steps, on one device.

Counterpart of ``page_segmentation_tpu/train/steps.py`` ``make_step_fns``.
A step is forward, loss, backward, optimizer update and metrics, run
eagerly (the JAX package compiles it into one program).  Batches are dicts
in one of two layouts:

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
``state_dict`` layout) and ``opt_state`` the ``train/optim.py`` state; the
train step returns new ones and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.utils.checkpoint
from torch.func import functional_call

from . import metrics as M
from .optim import map_tree


def make_step_fns(
    module,
    optimizer,
    loss_fn: Callable,
    mesh=None,
    remat: bool = False,
    device_preprocess: Optional[Callable] = None,
    skip_nonfinite: bool = False,
    class_weights=None,
):
    """(train_step, eval_step).

    train_step(params, model_state, opt_state, batch, dropout_rng=None)
        -> (params, model_state, opt_state, metrics)
    eval_step(params, model_state, batch) -> metrics

    Metrics are 0-d tensors on the batch's device.  ``model_state`` is the
    models' non-param state ({} for the FCN families); ``dropout_rng`` is
    accepted for the JAX signature (the FCN families have no dropout).
    ``skip_nonfinite``: a step whose loss or gradients are not finite keeps
    the params and optimizer state it was given and reports ``nonfinite``
    = 1.  ``remat`` recomputes the forward in the backward pass
    (``torch.utils.checkpoint``) instead of keeping its activations.
    ``train_step.value_and_grad(params, model_state, batch)`` gives the
    optimized loss and the gradients of one batch.
    """
    if mesh is not None:
        raise NotImplementedError(
            "data-parallel steps over a device mesh are not ported yet: ROADMAP queue 1 item 12")
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

    def forward(params, image):
        return functional_call(module, params, (image,))

    def loss_and_logits(params, batch):
        image = batch["image"]
        if remat:
            logits = torch.utils.checkpoint.checkpoint(forward, params, image, use_reentrant=False)
        else:
            logits = forward(params, image)
        weights = batch.get("loss_weights", batch.get("weights"))
        return loss_fn(batch["mask"], logits, weights=weights), logits

    def grads_of(params, batch):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss_value, logits = loss_and_logits(leaves, batch)
        grads = torch.autograd.grad(loss_value, list(leaves.values()))
        return loss_value.detach(), logits.detach(), dict(zip(leaves, grads))

    def value_and_grad(params, model_state, batch):
        loss_value, _, grads = grads_of(params, unpack(batch))
        return loss_value, grads

    def train_step(params, model_state, opt_state, batch, dropout_rng=None):
        batch = unpack(batch)
        loss_value, logits, grads = grads_of(params, batch)
        with torch.no_grad():
            updates, new_opt_state = optimizer.update(grads, opt_state, params)
            new_params = {k: v.detach() + updates[k] for k, v in params.items()}
            step_metrics = compute_metrics(batch, logits)
            if skip_nonfinite:
                finite = torch.isfinite(loss_value)
                for g in grads.values():
                    finite = finite & torch.isfinite(g).all()

                def keep(new, old):
                    return torch.where(finite, new, old)

                new_params = {k: keep(v, params[k].detach()) for k, v in new_params.items()}
                new_opt_state = map_tree(keep, new_opt_state, opt_state)
                step_metrics["nonfinite"] = 1.0 - finite.to(torch.float32)
            if n_cw:
                step_metrics["loss_weighted"] = loss_value
            else:
                step_metrics["loss"] = loss_value
        return new_params, model_state, new_opt_state, step_metrics

    def eval_step(params, model_state, batch):
        with torch.no_grad():
            batch = unpack(batch)
            return compute_metrics(batch, forward(params, batch["image"]))

    train_step.value_and_grad = value_and_grad
    return train_step, eval_step
