"""The port's data-parallel train and eval steps (``train/steps.py``
``make_step_fns(mesh=...)``) and ``Trainer(n_devices=2)`` against the JAX
package's ``shard_map`` steps and trainer on its virtual CPU devices, on
the CPU.

A batch of 3 pages padded to 4 (zero pages of weight 0) splits over 4
devices, where one shard is pure padding, and over 2, where one shard
carries a padded page.  Float32 FCNSkip from a flax init: against the JAX
mesh step, the reduced metrics to 1e-5 relative, the new parameters to
1e-4 relative in norm and the SGD update itself to 1e-3 (float32 summation
order alone moves JAX's own mesh update from its single-device one by
1.4e-4 on conv3's bias); against the port's own single-device step on the
3 pages (the mesh sums the shards' scaled gradients, so it is that step),
the loss to 1e-5 and the gradients to 1e-4.  A BatchNorm family is in
``test_torch_train_mesh_bn.py``, the Trainer on a mesh in
``test_torch_train_mesh_trainer.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from page_segmentation_tpu.models.fcn import FCNSkip as JaxFCNSkip
from page_segmentation_tpu.models.registry import Optimizers as JaxOptimizers
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu.train import metrics as jax_metrics
from page_segmentation_tpu.train.steps import make_step_fns as jax_make_step_fns
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax, params_to_jax
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.parallel.mesh import make_mesh
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns

H, W = 40, 32
DIMS = [(40, 32), (34, 26), (40, 32), (0, 0)]  # the last page is mesh padding
LR = 0.5
CLASS_WEIGHTS = np.float32([0.6, 2.5])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    """The 3 pages and a padding page as a compact and a float batch."""
    rng = np.random.default_rng(7)
    n = len(DIMS)
    compact = {"image": np.zeros((n, H, W, 1), np.uint8), "binary": np.zeros((n, H, W), np.uint8),
               "mask": np.zeros((n, H, W), np.uint8), "dims": np.int32(DIMS)}
    weights = np.zeros((n, H, W), np.float32)
    for i, (h, w) in enumerate(DIMS[:3]):
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4 : 3 * h // 4, 3 : w - 3] = 1
        image = np.where(mask == 1, 200, 15) + rng.integers(-8, 8, (h, w))
        compact["image"][i, :h, :w, 0] = np.clip(image, 0, 255)
        compact["binary"][i, :h, :w] = mask
        compact["mask"][i, :h, :w] = mask
        weights[i, :h, :w] = 1.0
    flt = {"image": compact["image"].astype(np.float32) / 255.0, "binary": compact["binary"],
           "mask": compact["mask"].astype(np.int32), "weights": weights}
    return {"compact": compact, "float": flt}


def _torch(batch, rows=slice(None)):
    return {k: torch.from_numpy(np.ascontiguousarray(v[rows])) for k, v in batch.items()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = np.asarray(value, np.float64)
    return out


def _assert_trees_close(got, want, tol):
    """Each leaf within ``tol`` relative in norm (leaves that are zero, as
    the BatchNorm biases before a BatchNorm, within 1e-12 absolute)."""
    got = _flat(got)
    for path, value in _flat(want).items():
        diff = np.linalg.norm(got[path] - value)
        assert diff <= tol * np.linalg.norm(value) + 1e-12, (path, _rel(got[path], value))


def _delta(new, old):
    new = _flat(new)
    return {path: new[path] - value for path, value in _flat(old).items()}


@pytest.mark.parametrize("n_dev, layout, class_weights", [
    (4, "compact", None), (2, "float", None), (2, "compact", CLASS_WEIGHTS)])
def test_fcn_mesh_step_matches_jax_and_one_device(n_dev, layout, class_weights):
    batch = _batches()[layout]
    jax_module = JaxFCNSkip(n_classes=2)
    params_np = jax.device_get(jax.jit(jax_module.init)(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, H, W, 1)))["params"])
    jopt = optax.inject_hyperparams(lambda learning_rate: JaxOptimizers.SGD.make(learning_rate))(
        learning_rate=LR)
    jax_train, jax_eval = jax_make_step_fns(jax_module, jopt, jax_metrics.loss,
                                            mesh=jax_make_mesh(n_dev), donate=False,
                                            class_weights=class_weights)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    want_params, _, _, want = jax_train(jp, {}, jopt.init(jp), batch, jax.random.PRNGKey(0))
    want_eval = jax_eval(jp, {}, batch)

    popt = Optimizers.SGD.make(LR)
    kwargs = dict(device_preprocess=Architecture.FCN_SKIP.device_preprocess(),
                  class_weights=class_weights)
    train_step, eval_step = make_step_fns(FCNSkip(2), popt, metrics.loss,
                                          mesh=make_mesh(n_dev, devices="cpu"), **kwargs)
    params = params_from_jax(params_np)
    new_params, new_state, _, got = train_step(params, {}, popt.init(params), _torch(batch))
    assert new_state == {} and set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)
    got_eval = eval_step(params, {}, _torch(batch))
    for key in want_eval:
        np.testing.assert_allclose(float(got_eval[key]), float(want_eval[key]), rtol=1e-5,
                                   err_msg=key)
    want_params = jax.device_get(want_params)
    _assert_trees_close(params_to_jax(new_params), want_params, 1e-4)
    _assert_trees_close({"update": _delta(params_to_jax(new_params), params_np)},
                        {"update": _delta(want_params, params_np)}, 1e-3)

    # the port's own oracle: the single-device step on the 3 real pages
    single, single_eval = make_step_fns(FCNSkip(2), popt, metrics.loss, **kwargs)
    loss, grads = single.value_and_grad(params, {}, _torch(batch, slice(0, 3)))
    mesh_loss, mesh_grads = train_step.value_and_grad(params, {}, _torch(batch))
    assert abs(float(mesh_loss) - float(loss)) <= 1e-5 * abs(float(loss))
    for k in grads:
        assert _rel(mesh_grads[k].numpy(), grads[k].numpy()) < 1e-4, k
    for key, value in single_eval(params, {}, _torch(batch, slice(0, 3))).items():
        np.testing.assert_allclose(float(got_eval[key]), float(value), rtol=1e-5, err_msg=key)


def test_nonfinite_shard_skips_the_whole_step():
    batch = _batches()["float"]
    bad = dict(batch, image=batch["image"].copy())
    bad["image"][0] = np.inf  # one page of the first shard
    popt = Optimizers.ADAM.make(1e-3)
    train_step, _ = make_step_fns(FCNSkip(2), popt, metrics.loss, skip_nonfinite=True,
                                  mesh=make_mesh(2, devices="cpu"))
    params = params_from_jax(init_params_numpy(2, seed=0))
    state = popt.init(params)
    kept, _, kept_state, m = train_step(params, {}, state, _torch(bad))
    assert float(m["nonfinite"]) == 1.0 and int(kept_state["count"]) == 0
    assert all(torch.equal(kept[k], params[k]) for k in params)
    moved, _, _, m = train_step(params, {}, state, _torch(batch))
    assert float(m["nonfinite"]) == 0.0 and any(not torch.equal(moved[k], params[k]) for k in params)
