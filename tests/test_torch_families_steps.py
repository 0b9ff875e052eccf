"""One training-mode step of the model families against the JAX step: the
loss, the gradients and the new BatchNorm statistics, from the same weights
and the same batch.

The JAX side is its step's core: ``module.apply(..., train=True,
mutable=["batch_stats"])`` under ``jax.value_and_grad``.  The BatchNorm
families run in float64 (the JAX side under ``jax.enable_x64``), where the
two agree to 1e-6: in float32 flax's batch variance ``E[x²] - E[x]²``
cancels on near-constant channels, and the other summation order alone
moves the gradients by ~1e-3 at these small sizes.  ResUNet, without
BatchNorm, runs in float32, to 1e-3 (ReLU kinks near 0 flip with the
summation order).  EfficientNet's and UNet's steps, the slowest to compile,
are in ``test_torch_families_steps_deep.py`` and
``test_torch_families_steps_unet.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.train import metrics as jax_metrics
from page_segmentation_tpu_torch.models.bridge import params_to_jax
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.ops.prng import prng_key
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns
from tests.torch_families import calibrated, page_input


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(arch, seed=0):
    x = page_input(arch, seed=seed)
    n, h, w = x.shape[:3]
    rng = np.random.default_rng(seed + 7)
    mask = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    weights = np.ones((n, h, w), np.float32)
    weights[:, -5:] = 0  # bucket padding
    return x, mask, weights


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel() for a in jax.tree_util.tree_leaves(tree)])


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def step_both(name, dtype="float64", dropout_seed=None, jax_train=True):
    """(port, JAX) of one step: (loss, gradient tree, new statistics); with
    ``dropout_seed`` both draw their dropout under ``PRNGKey(dropout_seed)``.
    ``jax_train=False`` applies the JAX module in eval mode (for UNet, whose
    flag only switches its dropouts, the step without dropout)."""
    arch = Architecture(name)
    rngs = {} if dropout_seed is None else {"rngs": {"dropout": jax.random.PRNGKey(dropout_seed)}}
    x, mask, weights = _batch(arch)
    module, variables = calibrated(arch, x, dtype=getattr(torch, dtype))
    stats = variables.get("batch_stats")
    with jax.enable_x64(dtype == "float64"):
        jax_module = JaxArchitecture(name).model(3, dtype=getattr(jnp, dtype))

        def loss_of(params):
            if stats is None:
                return jax_metrics.loss(mask, jax_module.apply({"params": params}, x, train=jax_train, **rngs),
                                        weights=weights), {}
            logits, new_state = jax_module.apply({"params": params, "batch_stats": stats}, x,
                                                 train=True, mutable=["batch_stats"], **rngs)
            return jax_metrics.loss(mask, logits, weights=weights), new_state

        (want_loss, want_state), want_grads = jax.jit(
            jax.value_and_grad(loss_of, has_aux=True))(variables["params"])
    step, _ = make_step_fns(module, Optimizers.ADAM.make(1e-3), metrics.loss)
    batch = {"image": torch.from_numpy(x), "mask": torch.from_numpy(mask),
             "weights": torch.from_numpy(weights), "binary": torch.ones(mask.shape, dtype=torch.uint8)}
    key = None if dropout_seed is None else prng_key(dropout_seed)
    loss, grads, state = step.value_and_grad(dict(module.named_parameters()),
                                             dict(module.named_buffers()), batch, key, with_state=True)
    assert not module.training  # the step hands the module back in eval mode
    return (float(loss), params_to_jax(grads), state), (float(want_loss), want_grads, want_state)


def assert_bn_step_matches(name):
    (loss, grads, state), (want_loss, want_grads, want_state) = step_both(name)
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert jax.tree_util.tree_structure(grads) == jax.tree_util.tree_structure(dict(want_grads))
    assert _rel(_flat(grads), _flat(dict(want_grads))) < 1e-6
    new_stats = params_to_jax(state)["batch_stats"]
    assert jax.tree_util.tree_structure(new_stats) == \
        jax.tree_util.tree_structure(dict(want_state)["batch_stats"])
    assert _rel(_flat(new_stats), _flat(dict(want_state)["batch_stats"])) < 1e-6
    return grads, dict(want_grads), new_stats


@pytest.mark.parametrize("name", ["mobile_net", "image_res_net"])
def test_bn_family_train_step_matches_jax(name):
    assert_bn_step_matches(name)


def test_res_unet_train_step_matches_jax():
    (loss, grads, state), (want_loss, want_grads, _) = step_both("res_unet", "float32")
    assert state == {}
    assert loss == pytest.approx(want_loss, rel=1e-6)
    assert _rel(_flat(grads), _flat(dict(want_grads))) < 1e-3
