"""The trainer's optimizers as plain functions on tensors.

Counterpart of what the JAX trainer builds with optax
(``page_segmentation_tpu/train/trainer.py`` and ``models/registry.py``
``Optimizers.make``)::

    inject_hyperparams(chain([per_leaf_norm_clip], [clip], base))(learning_rate)
    MultiSteps(..., every_k_schedule=grad_accum)          # grad_accum > 1

with optax's defaults and its order of operations for the seven base rules
(``torch.optim`` folds Adam's bias corrections differently and drifts by
~1e-7 relative):

* ``per_leaf_norm_clip``: Keras ``clipnorm``, each gradient tensor clipped
  by its own L2 norm (not the global norm of ``clip_grad_norm_``);
* ``clip``: each element clipped to [-c, c];
* the base rule, then ``-learning_rate`` times its output;
* the learning rate lives in the state (``set_lr`` changes it, as
  ``Trainer._set_lr`` does), or a schedule sets it from the update count
  before the count is incremented, as ``inject_hyperparams`` does;
* ``MultiSteps``: a running mean of ``k`` micro-gradients, applied once
  every ``k`` steps, zero updates in between.

The state is a dict of tensors in the port's layout (leaves keyed like the
module's ``state_dict``), updated without leaving the device.
:meth:`Optimizer.state_dict` maps it to optax's state dict with the leaves
in the JAX param layout (what ``opt_state.msgpack`` holds) and
:meth:`Optimizer.load_state_dict` maps it back.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Union

import numpy as np
import torch

from ..models.bridge import params_from_jax, params_to_jax

Tree = Dict[str, torch.Tensor]
_INT32_MAX = 2 ** 31 - 1

# per base rule: its optax chain (the slot names of each element's state,
# [] for an empty state) and whether it keeps its own update count
_BASE_LAYOUT = {
    "adam": ([["mu", "nu"], []], True),
    "nadam": ([["mu", "nu"], []], True),
    "adamax": ([["mu", "nu"], []], True),
    "adadelta": ([[], ["e_g", "e_x"], []], False),
    "adagrad": ([["sum_of_squares"], []], False),
    "rmsprop": ([["nu"], [], []], False),
    "sgd": ([[], []], False),
}


def _safe_increment(count: torch.Tensor) -> torch.Tensor:
    return torch.where(count < _INT32_MAX, count + 1, count)


def _bias_correction(decay: float, count: torch.Tensor) -> torch.Tensor:
    """1 - decay ** count in float32.  The base is filled on the device:
    ``torch.tensor(decay, device=...)`` copies from the host and waits for
    the device to finish what was launched before it, once a step."""
    base = torch.full((), decay, dtype=torch.float32, device=count.device)
    return 1 - torch.pow(base, count.to(torch.float32))


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """optax's ``warmup_cosine_decay_schedule``: a linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then a cosine
    decay to ``end_value`` at ``decay_steps``; count -> float32 value."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got "
                         f"decay_steps={decay_steps - warmup_steps}.")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = float(decay_steps - warmup_steps)

    def warmup(count):
        if warmup_steps <= 0:
            return torch.full_like(count, init_value, dtype=torch.float32)
        frac = 1 - count.clamp(0, warmup_steps).to(torch.float32) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    def cosine(count):
        count = count.to(torch.float32).clamp_max(cosine_steps)
        decay = 0.5 * (1 + torch.cos(math.pi * count / cosine_steps))
        return peak_value * ((1 - alpha) * decay ** exponent + alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, warmup(count), cosine(count - warmup_steps))

    return schedule


def per_leaf_norm_clip(max_norm: float) -> Callable[[Tree], Tree]:
    """Keras ``clipnorm``: each gradient tensor scaled down to the L2 norm
    ``max_norm`` where its own norm exceeds it.  Each norm is its own
    tensor's ``sqrt(sum(x * x))``; the elementwise steps run over all the
    tensors at once."""

    def clip(grads: Tree) -> Tree:
        if not grads:
            return {}
        keys, g = list(grads), list(grads.values())
        norms = torch.stack(torch._foreach_sqrt([s.sum() for s in torch._foreach_mul(g, g)]))
        scales = torch.where(norms > max_norm, max_norm / (norms + 1e-12), 1.0)
        return dict(zip(keys, torch._foreach_mul(g, [s.to(x.dtype) for s, x in zip(scales, g)])))

    return clip


def map_tree(fn, *trees):
    """``fn`` over the leaves of nested dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Optimizer:
    """One of the seven base rules behind optional clipping, with the
    learning rate in the state and optional gradient accumulation.

    ``init(params)`` -> state; ``update(grads, state, params)`` -> (updates,
    new state), where the new params are ``params + updates``."""

    def __init__(self, kind: str, learning_rate: Union[float, Callable],
                 norm_clipping: bool = True, norm_clip_value: float = 1.0,
                 value_clipping: bool = False, clip_value: float = 1.0, grad_accum: int = 1):
        if kind not in _BASE_LAYOUT:
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.learning_rate = learning_rate
        self.schedule = learning_rate if callable(learning_rate) else None
        self.norm_clipping = norm_clipping
        self.norm_clip_value = norm_clip_value
        self.value_clipping = value_clipping
        self.clip_value = clip_value
        self.grad_accum = int(grad_accum)

    # ------------------------------------------------------------- the state
    def _inner_init(self, params: Tree) -> dict:
        device = next(iter(params.values())).device
        zero = torch.zeros((), dtype=torch.int32, device=device)
        lr = (self.schedule(zero) if self.schedule is not None
              else torch.tensor(self.learning_rate, dtype=torch.float32, device=device))
        fill = 0.1 if self.kind == "adagrad" else 0.0  # adagrad's initial accumulator
        chain, counted = _BASE_LAYOUT[self.kind]
        state = {"count": zero.clone(), "learning_rate": lr.to(torch.float32),
                 "base": {slot: {k: torch.full_like(v, fill, dtype=torch.float32)
                                 for k, v in params.items()}
                          for slots in chain for slot in slots}}
        if counted:
            state["base_count"] = zero.clone()
        if self.schedule is not None:
            state["schedule_count"] = zero.clone()
        return state

    def init(self, params: Tree) -> dict:
        inner = self._inner_init(params)
        if self.grad_accum <= 1:
            return inner
        zero = inner["count"]
        return {"mini_step": zero.clone(), "gradient_step": zero.clone(), "inner": inner,
                "acc_grads": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}}

    def inner_state(self, state: dict) -> dict:
        return state["inner"] if self.grad_accum > 1 else state

    def set_lr(self, state: dict, lr: float) -> None:
        inner = self.inner_state(state)
        inner["learning_rate"] = torch.tensor(lr, dtype=torch.float32,
                                              device=inner["learning_rate"].device)

    def current_lr(self, state: dict) -> float:
        return float(self.inner_state(state)["learning_rate"])

    # ------------------------------------------------------------ the update
    def _base(self, g: Tree, state: dict, params: Tree):
        """The base rule's direction (before the learning rate) and its new
        slots and count."""
        kind, b = self.kind, state["base"]
        if kind == "sgd":
            return g, {}, None
        if kind in ("adam", "nadam", "adamax"):
            # over all the tensors at once, each step optax's float32 operation
            b1, b2 = 0.9, 0.999
            count = _safe_increment(state["base_count"])
            keys = list(g)
            gs, mus, nus = ([t[k] for k in keys] for t in (g, b["mu"], b["nu"]))
            mu = torch._foreach_add(torch._foreach_mul(gs, 1 - b1), torch._foreach_mul(mus, b1))
            c1 = _bias_correction(b1, count)
            if kind == "adamax":
                nu = torch._foreach_maximum(torch._foreach_add(torch._foreach_abs(gs), 1e-8),
                                            torch._foreach_mul(nus, b2))
                out = torch._foreach_div(torch._foreach_div(mu, c1), nu)
            else:
                nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(gs, gs), 1 - b2),
                                        torch._foreach_mul(nus, b2))
                if kind == "nadam":
                    c1_next = _bias_correction(b1, _safe_increment(count))
                    mu_hat = torch._foreach_add(
                        torch._foreach_mul(torch._foreach_div(mu, c1_next), b1),
                        torch._foreach_mul(torch._foreach_div(gs, c1), 1 - b1))
                else:
                    mu_hat = torch._foreach_div(mu, c1)
                c2 = _bias_correction(b2, count)
                denom = torch._foreach_add(
                    torch._foreach_sqrt(torch._foreach_add(torch._foreach_div(nu, c2), 0.0)), 1e-8)
                out = torch._foreach_div(mu_hat, denom)
            return (dict(zip(keys, out)), {"mu": dict(zip(keys, mu)), "nu": dict(zip(keys, nu))},
                    count)
        if kind == "adadelta":
            rho, eps = 0.9, 1e-6
            g = {k: g[k] + 0.0 * params[k] for k in g}  # add_decayed_weights(0.0)
            e_g = {k: (1 - rho) * (g[k] * g[k]) + rho * b["e_g"][k] for k in g}
            out = {k: (torch.sqrt(b["e_x"][k] + eps) / torch.sqrt(e_g[k] + eps)) * g[k] for k in g}
            e_x = {k: (1 - rho) * (out[k] * out[k]) + rho * b["e_x"][k] for k in g}
            return out, {"e_g": e_g, "e_x": e_x}, None
        if kind == "adagrad":
            sos = {k: g[k] * g[k] + b["sum_of_squares"][k] for k in g}
            out = {k: torch.where(sos[k] > 0, torch.rsqrt(sos[k] + 1e-7), 0.0) * g[k] for k in g}
            return out, {"sum_of_squares": sos}, None
        # rmsprop
        nu = {k: (1 - 0.9) * (g[k] * g[k]) + 0.9 * b["nu"][k] for k in g}
        return {k: torch.rsqrt(nu[k] + 1e-8) * g[k] for k in g}, {"nu": nu}, None

    def _inner_update(self, grads: Tree, state: dict, params: Tree):
        g = grads
        if self.norm_clipping:
            g = per_leaf_norm_clip(self.norm_clip_value)(g)
        if self.value_clipping:
            g = {k: v.clamp(-self.clip_value, self.clip_value) for k, v in g.items()}
        new = {"count": _safe_increment(state["count"])}
        if self.schedule is not None:
            new["learning_rate"] = self.schedule(state["schedule_count"]).to(torch.float32)
            new["schedule_count"] = _safe_increment(state["schedule_count"])
        else:
            new["learning_rate"] = state["learning_rate"]
        direction, slots, count = self._base(g, state, params)
        new["base"] = slots
        if count is not None:
            new["base_count"] = count
        step = -1 * new["learning_rate"]
        return dict(zip(direction, torch._foreach_mul(list(direction.values()), step))), new

    def update(self, grads: Tree, state: dict, params: Tree):
        """(updates, new state) for the gradients ``grads`` of ``params``."""
        if self.grad_accum <= 1:
            return self._inner_update(grads, state, params)
        k_steps, mini = self.grad_accum, state["mini_step"]
        acc = {k: state["acc_grads"][k] + (grads[k] - state["acc_grads"][k]) / (mini + 1)
               for k in grads}
        final, new_inner = self._inner_update(acc, state["inner"], params)
        emit = mini == k_steps - 1
        new_state = {
            "mini_step": _safe_increment(mini) % k_steps,
            "gradient_step": torch.where(emit, _safe_increment(state["gradient_step"]),
                                         state["gradient_step"]),
            "inner": map_tree(lambda old, new: torch.where(emit, new, old), state["inner"], new_inner),
            "acc_grads": {k: (~emit) * v for k, v in acc.items()},
        }
        return {k: emit * v for k, v in final.items()}, new_state

    # ---------------------------------------------- optax's layout on disk
    def _inner_to_optax(self, state: dict) -> dict:
        chain, counted = _BASE_LAYOUT[self.kind]
        base = {}
        for i, slots in enumerate(chain):
            element = {slot: params_to_jax(state["base"][slot]) for slot in slots}
            if counted and i == 0:
                element["count"] = _np(state["base_count"])
            base[str(i)] = element
        n_clips = int(self.norm_clipping) + int(self.value_clipping)
        inner_chain = {str(i): {} for i in range(n_clips)}
        inner_chain[str(n_clips)] = base
        return {
            "count": _np(state["count"]),
            "hyperparams": {"learning_rate": _np(state["learning_rate"])},
            "hyperparams_states": ({"learning_rate": {"count": _np(state["schedule_count"])}}
                                   if self.schedule is not None else {}),
            "inner_state": inner_chain,
        }

    def state_dict(self, state: dict) -> dict:
        """optax's state dict of ``state``: numpy leaves, moments in the JAX
        param layout (``{layer: {"kernel", "bias"}}``)."""
        if self.grad_accum <= 1:
            return self._inner_to_optax(state)
        return {"mini_step": _np(state["mini_step"]),
                "gradient_step": _np(state["gradient_step"]),
                "inner_opt_state": self._inner_to_optax(state["inner"]),
                "acc_grads": params_to_jax(state["acc_grads"]),
                "skip_state": {}}

    def _inner_from_optax(self, tree: dict, device) -> dict:
        chain, counted = _BASE_LAYOUT[self.kind]
        n_clips = int(self.norm_clipping) + int(self.value_clipping)
        base = tree["inner_state"][str(n_clips)]
        state = {"count": _tensor(tree["count"], device),
                 "learning_rate": _tensor(tree["hyperparams"]["learning_rate"], device),
                 "base": {slot: _from_jax(base[str(i)][slot], device)
                          for i, slots in enumerate(chain) for slot in slots}}
        if counted:
            state["base_count"] = _tensor(base["0"]["count"], device)
        if self.schedule is not None:
            state["schedule_count"] = _tensor(tree["hyperparams_states"]["learning_rate"]["count"],
                                              device)
        return state

    def load_state_dict(self, tree: dict, device) -> dict:
        """The inverse of :meth:`state_dict`, on ``device``."""
        if self.grad_accum <= 1:
            return self._inner_from_optax(tree, device)
        return {"mini_step": _tensor(tree["mini_step"], device),
                "gradient_step": _tensor(tree["gradient_step"], device),
                "inner": self._inner_from_optax(tree["inner_opt_state"], device),
                "acc_grads": _from_jax(tree["acc_grads"], device)}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device)


def _from_jax(leaves, device) -> Tree:
    return {k: v.to(device) for k, v in params_from_jax(leaves).items()}