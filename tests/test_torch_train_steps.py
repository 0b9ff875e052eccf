"""One training step of the port (``train/steps.py``) against the JAX
package's on the same params and batch, in float32: the loss to 1e-5
relative, every gradient leaf to 1e-4 relative in norm.  One page of the
batch is padded, so its zero padding makes max-pool ties in the backward
pass."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from page_segmentation_tpu.models.fcn import FCNSkip as JaxFCNSkip
from page_segmentation_tpu.models.registry import Optimizers as JaxOptimizers
from page_segmentation_tpu.train import metrics as jax_metrics
from page_segmentation_tpu.train.steps import make_step_fns as jax_make_step_fns
from page_segmentation_tpu_torch.models.bridge import params_from_jax, params_to_jax
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns

H, W = 40, 32
@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # the suite runs several test processes on the machine's cores; torch's
    # own thread pool in each then oversubscribes them, and these small
    # steps run tens of times slower
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DIMS = [(40, 32), (34, 26), (40, 32)]
CLASS_WEIGHTS = np.float32([0.6, 2.5])


@pytest.fixture(scope="module")
def jax_params():
    module = JaxFCNSkip(n_classes=2)
    params = jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 1)))["params"]
    return jax.device_get(params)


def _batches():
    """The same pages as a compact batch (uint8 + dims) and a float batch."""
    rng = np.random.default_rng(7)
    n = len(DIMS)
    compact = {"image": np.zeros((n, H, W, 1), np.uint8), "binary": np.zeros((n, H, W), np.uint8),
               "mask": np.zeros((n, H, W), np.uint8), "dims": np.int32(DIMS)}
    weights = np.zeros((n, H, W), np.float32)
    for i, (h, w) in enumerate(DIMS):
        mask = np.zeros((h, w), np.uint8)
        mask[h // 4 : 3 * h // 4, 3 : w - 3] = 1
        image = np.where(mask == 1, 200, 15) + rng.integers(-8, 8, (h, w))
        compact["image"][i, :h, :w, 0] = np.clip(image, 0, 255)
        compact["binary"][i, :h, :w] = mask
        compact["mask"][i, :h, :w] = mask
        weights[i, :h, :w] = 1.0
    flt = {"image": compact["image"].astype(np.float32) / 255.0, "binary": compact["binary"],
           "mask": compact["mask"].astype(np.int32), "weights": weights}
    return compact, flt


def _torch(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def _port_steps(optimizer=None, **kwargs):
    module = FCNSkip(2)
    optimizer = optimizer or Optimizers.ADAM.make(1e-3)
    return make_step_fns(module, optimizer, metrics.loss,
                         device_preprocess=Architecture.FCN_SKIP.device_preprocess(), **kwargs)


def _rel_norm(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30))


def _assert_grads_close(port_grads, jax_grads, tol):
    got = params_to_jax(port_grads)
    for layer, leaves in jax_grads.items():
        for leaf, want in leaves.items():
            assert _rel_norm(got[layer][leaf], want) < tol, (layer, leaf, _rel_norm(got[layer][leaf], want))


def test_one_step_loss_and_grads_match_jax(jax_params):
    compact, flt = _batches()
    module = JaxFCNSkip(n_classes=2)

    def loss_of(p):
        logits = module.apply({"params": p}, jnp.asarray(flt["image"]))
        return jax_metrics.loss(jnp.asarray(flt["mask"]), logits, weights=jnp.asarray(flt["weights"]))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_of))(
        jax.tree_util.tree_map(jnp.asarray, jax_params))
    train_step, eval_step = _port_steps()
    params = params_from_jax(jax_params)
    loss, grads = train_step.value_and_grad(params, {}, _torch(flt))
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    _assert_grads_close(grads, jax.device_get(want_grads), 1e-4)

    # the eval step's metrics, against the JAX package's eval step
    _, jax_eval = jax_make_step_fns(module, optax.sgd(1e-3), jax_metrics.loss, donate=False)
    want = jax_eval(jax_params, {}, compact)
    got = eval_step(params, {}, _torch(compact))
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, err_msg=key)


def test_compact_layout_equals_float_layout(jax_params):
    compact, flt = _batches()
    train_step, _ = _port_steps()
    params = params_from_jax(jax_params)
    loss_c, grads_c = train_step.value_and_grad(params, {}, _torch(compact))
    loss_f, grads_f = train_step.value_and_grad(params, {}, _torch(flt))
    assert float(loss_c) == pytest.approx(float(loss_f), rel=1e-6)
    for k in grads_f:
        assert _rel_norm(grads_c[k].numpy(), grads_f[k].numpy()) < 1e-5, k


def test_class_weights_scale_loss_weighted_only(jax_params):
    compact, _ = _batches()
    kind = "adam"
    popt = Optimizers(kind).make(1e-3)
    params = params_from_jax(jax_params)
    plain_step, _ = _port_steps(popt)
    weighted_step, _ = _port_steps(popt, class_weights=CLASS_WEIGHTS)
    _, _, _, plain = plain_step(params, {}, popt.init(params), _torch(compact))
    new_params, _, _, weighted = weighted_step(params, {}, popt.init(params), _torch(compact))
    assert float(weighted["loss"]) == pytest.approx(float(plain["loss"]), rel=1e-6)
    assert float(weighted["loss_weighted"]) != pytest.approx(float(plain["loss"]), rel=1e-3)

    # and the whole step against the JAX package's, class weights included
    jopt = optax.inject_hyperparams(lambda learning_rate: JaxOptimizers(kind).make(learning_rate))(
        learning_rate=1e-3)
    jax_step, _ = jax_make_step_fns(JaxFCNSkip(n_classes=2), jopt, jax_metrics.loss, donate=False,
                                    class_weights=CLASS_WEIGHTS)
    jp = jax.tree_util.tree_map(jnp.asarray, jax_params)
    want_params, _, _, want = jax_step(jp, {}, jopt.init(jp), compact, jax.random.PRNGKey(0))
    for key in ("loss", "loss_weighted", "accuracy", "fgpa", "jacard_coef", "dice_coef"):
        np.testing.assert_allclose(float(weighted[key]), float(want[key]), rtol=1e-5, err_msg=key)
    got_params = params_to_jax(new_params)
    for layer, leaves in jax.device_get(want_params).items():
        for leaf, value in leaves.items():
            np.testing.assert_allclose(got_params[layer][leaf], value, rtol=1e-4, atol=2e-6,
                                       err_msg=f"{layer}/{leaf}")


def test_nonfinite_batch_keeps_params_and_state(jax_params):
    _, flt = _batches()
    popt = Optimizers.ADAM.make(1e-3)
    train_step, _ = _port_steps(popt, skip_nonfinite=True)
    params = params_from_jax(jax_params)
    state = popt.init(params)
    bad = {**flt, "image": np.full_like(flt["image"], np.inf)}
    p1, _, s1, m1 = train_step(params, {}, state, _torch(bad))
    assert float(m1["nonfinite"]) == 1.0
    for k in params:
        assert torch.equal(p1[k], params[k])
    for slot in ("mu", "nu"):
        for k in params:
            assert torch.equal(s1["base"][slot][k], state["base"][slot][k])
    assert int(s1["count"]) == 0 and int(s1["base_count"]) == 0
    p2, _, s2, m2 = train_step(p1, {}, s1, _torch(flt))
    assert float(m2["nonfinite"]) == 0.0 and int(s2["count"]) == 1
    assert any(not torch.equal(p2[k], params[k]) for k in params)


def test_remat_gives_the_same_gradients(jax_params):
    _, flt = _batches()
    params = params_from_jax(jax_params)
    plain, _ = _port_steps()
    remat, _ = _port_steps(remat=True)
    loss_a, grads_a = plain.value_and_grad(params, {}, _torch(flt))
    loss_b, grads_b = remat.value_and_grad(params, {}, _torch(flt))
    assert float(loss_a) == float(loss_b)
    for k in grads_a:
        np.testing.assert_allclose(grads_b[k].numpy(), grads_a[k].numpy(), rtol=1e-6, atol=1e-9)


def test_mesh_names_its_item(jax_params):
    # ported (tests/test_torch_train_mesh.py): a mesh step equals the
    # single-device step on the same pages
    from page_segmentation_tpu_torch.parallel.mesh import make_mesh

    _, flt = _batches()
    params = params_from_jax(jax_params)
    mesh_step, _ = _port_steps(mesh=make_mesh(3, devices="cpu"))
    single, _ = _port_steps()
    loss_m, grads_m = mesh_step.value_and_grad(params, {}, _torch(flt))
    loss_s, grads_s = single.value_and_grad(params, {}, _torch(flt))
    assert float(loss_m) == pytest.approx(float(loss_s), rel=1e-5)
    for k in grads_s:
        assert _rel_norm(grads_m[k].numpy(), grads_s[k].numpy()) < 1e-4, k
