"""The port's data-parallel train step with dropout against the JAX
package's ``shard_map`` step on its virtual CPU devices, on the CPU.

UNet (its two dropouts live) over a mesh of 2 shards of 2 pages each, from
one flax init, SGD, in float64 (the JAX side under ``jax.enable_x64``, whose
dropout draws 64 random bits an element, as the port does for float64):
each shard draws its masks under ``fold_in(dropout_rng, shard)`` over its
own pages, as the JAX step folds in ``axis_index`` before flax folds in the
layer's name.  The reduced metrics and the new parameters agree to 1e-6
relative (the parameters in the norm of the whole tree, as the float64
family steps hold their gradients, ``test_torch_families_steps.py``); the
SGD update itself to 1e-3, as ``test_torch_train_mesh.py`` holds FCNSkip's:
UNet casts its logits to float32, so its gradients carry float32's
rounding (measured: 1.5e-4).  The same step without its dropout key moves
the loss by 3.6e-5 relative, 36 times the loss's tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.models.registry import Optimizers as JaxOptimizers
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu.train import metrics as jax_metrics
from page_segmentation_tpu.train.steps import make_step_fns as jax_make_step_fns
from page_segmentation_tpu_torch.models.bridge import params_from_jax, params_to_jax
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.ops.prng import prng_key
from page_segmentation_tpu_torch.parallel.mesh import make_mesh
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns
from tests.test_torch_families_steps import _flat, _rel
from tests.test_torch_train_mesh import _delta

N, H, W = 4, 32, 48
LR = 0.05
SEED = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch():
    rng = np.random.default_rng(3)
    image = (rng.random((N, H, W, 1)) * 40).astype(np.float32)  # logits well away from 0
    mask = rng.integers(0, 2, (N, H, W)).astype(np.int32)
    weights = np.ones((N, H, W), np.float32)
    weights[-1, :, -6:] = 0
    return {"image": image, "binary": (mask == 1).astype(np.uint8), "mask": mask, "weights": weights}


def test_unet_mesh_step_with_dropout_matches_jax():
    batch = _batch()
    with jax.enable_x64(True):
        jax_module = JaxArchitecture.UNET.model(2, dtype=jnp.float64)
        params_np = jax.device_get(jax.jit(jax_module.init)(jax.random.PRNGKey(0),
                                                            jnp.zeros((1, H, W, 1)))["params"])
        params_np = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params_np)
        jopt = optax.inject_hyperparams(lambda learning_rate: JaxOptimizers.SGD.make(learning_rate))(
            learning_rate=LR)
        jax_train, _ = jax_make_step_fns(jax_module, jopt, jax_metrics.loss, mesh=jax_make_mesh(2),
                                         donate=False)
        jp = jax.tree_util.tree_map(jnp.asarray, params_np)
        want_params, _, _, want = jax_train(jp, {}, jopt.init(jp), batch, jax.random.PRNGKey(SEED))
        want_params = jax.device_get(want_params)

    popt = Optimizers.SGD.make(LR)
    train_step, _ = make_step_fns(Architecture.UNET.model(2, dtype=torch.float64), popt, metrics.loss,
                                  mesh=make_mesh(2, devices="cpu"))
    params = {k: v.double() for k, v in params_from_jax(params_np).items()}
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    new_params, _, _, got = train_step(params, {}, popt.init(params), torch_batch, prng_key(SEED))
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6, err_msg=key)
    got_params = params_to_jax(new_params)
    assert _rel(_flat(got_params), _flat(want_params)) < 1e-6
    got_update, want_update = _delta(got_params, params_np), _delta(want_params, params_np)
    assert _rel(np.concatenate([got_update[k].ravel() for k in want_update]),
                np.concatenate([v.ravel() for v in want_update.values()])) < 1e-3

    no_dropout = float(train_step.value_and_grad(params, {}, torch_batch)[0])
    assert abs(no_dropout - float(want["loss"])) > 1e-5 * float(want["loss"]), no_dropout
