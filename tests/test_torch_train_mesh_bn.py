"""The port's data-parallel train step on a BatchNorm family against the
JAX package's ``shard_map`` step on its virtual CPU devices, on the CPU:
mobile_net on 2 devices in float64 (the JAX side under x64), each shard
normalizing with its own batch statistics and the new running statistics
their mean; the reduced metrics to 1e-5, the gradients and the statistics
to 1e-4 relative in norm."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu.train import metrics as jax_metrics
from page_segmentation_tpu.train.steps import make_step_fns as jax_make_step_fns
from page_segmentation_tpu_torch.models.bridge import params_to_jax
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.parallel.mesh import make_mesh
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns
from tests.test_torch_train_mesh import LR, _assert_trees_close, _delta, _flat, _torch
from tests.torch_families import calibrated, page_input


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_batchnorm_family_mesh_step_matches_jax():
    """mobile_net on 2 devices in float64: each shard normalizes with its
    own batch statistics; the new running statistics are their mean."""
    arch = Architecture("mobile_net")
    x = page_input(arch, n=4)
    module, variables = calibrated(arch, x, dtype=torch.float64)
    n, h, w = x.shape[:3]
    mask = np.random.default_rng(7).integers(0, 3, (n, h, w)).astype(np.int32)
    weights = np.ones((n, h, w), np.float64)
    weights[:, -5:] = 0
    batch = {"image": x.astype(np.float64), "mask": mask, "binary": np.ones((n, h, w), np.uint8),
             "weights": weights}
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)  # noqa: E731
        jopt = optax.sgd(LR)
        jax_train, _ = jax_make_step_fns(JaxArchitecture("mobile_net").model(3, dtype=jnp.float64),
                                         jopt, jax_metrics.loss, mesh=jax_make_mesh(2), donate=False)
        jp = f64(variables["params"])
        want_params, want_state, _, want = jax.device_get(jax_train(
            jp, {"batch_stats": f64(variables["batch_stats"])}, jopt.init(jp), batch,
            jax.random.PRNGKey(0)))
    popt = Optimizers.SGD.make(LR)
    train_step, _ = make_step_fns(module, popt, metrics.loss, mesh=make_mesh(2, devices="cpu"))
    params, stats = dict(module.named_parameters()), dict(module.named_buffers())
    _, new_state, _, got = train_step(params, stats, popt.init(params), _torch(batch))
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    # the module keeps float32 parameters, so the gradients are compared, not
    # the float32 updates: JAX's are its float64 SGD update over -LR
    _, grads, _ = train_step.value_and_grad(params, stats, _torch(batch), with_state=True)
    want_grads = {path: -delta / LR for path, delta in _delta(want_params, variables["params"]).items()}
    _assert_trees_close({"grad": _flat(params_to_jax(grads))}, {"grad": want_grads}, 1e-4)
    got_stats = params_to_jax({**params, **new_state})["batch_stats"]
    _assert_trees_close(got_stats, want_state["batch_stats"], 1e-4)
    moved = _delta(got_stats, variables["batch_stats"])
    assert max(np.abs(v).max() for v in moved.values()) > 1e-6
