"""The port's optimizers (``train/optim.py``) against the optax chains the
JAX trainer builds, and the optimizer state on disk: updates to 1e-6, the
cosine LR to 1e-7, ``opt_state.msgpack`` byte-identical, each package
reading the other's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from page_segmentation_tpu.models.registry import Optimizers as JaxOptimizers
from page_segmentation_tpu.train import checkpoint as jax_checkpoint
from page_segmentation_tpu_torch.models.bridge import params_from_jax, params_to_jax
from page_segmentation_tpu_torch.models.registry import Optimizers
from page_segmentation_tpu_torch.train import checkpoint as port_checkpoint
from page_segmentation_tpu_torch.train.optim import warmup_cosine_decay_schedule

SHAPES = {"conv1": (5, 5, 1, 4), "deconv2": (2, 2, 3, 4), "logits": (1, 1, 3, 2)}


def _tree(rng, scale=1.0):
    tree = {}
    for name, shape in SHAPES.items():
        bias = shape[2] if name.startswith("deconv") else shape[3]
        tree[name] = {"kernel": (rng.normal(size=shape) * scale).astype(np.float32),
                      "bias": (rng.normal(size=bias) * scale).astype(np.float32)}
    return tree


def _jax_optimizer(kind, lr, norm_clipping, value_clipping=False, grad_accum=1):
    opt = optax.inject_hyperparams(lambda learning_rate: JaxOptimizers(kind).make(
        learning_rate, norm_clipping=norm_clipping, value_clipping=value_clipping,
        clip_value=0.05))(learning_rate=lr)
    return optax.MultiSteps(opt, every_k_schedule=grad_accum) if grad_accum > 1 else opt


def _port_optimizer(kind, lr, norm_clipping, value_clipping=False, grad_accum=1):
    return Optimizers(kind).make(lr, norm_clipping=norm_clipping, value_clipping=value_clipping,
                                 clip_value=0.05, grad_accum=grad_accum)


def _run_both(kind, norm_clipping, steps=3, lr=1e-2, value_clipping=False, grad_accum=1):
    """``steps`` updates of each package on the same seeded gradients
    (large enough that clipping acts): (jax params, jax state, port
    params, port state, port optimizer)."""
    rng = np.random.default_rng(3)
    params = _tree(rng)
    grads = [_tree(rng, scale=0.8) for _ in range(steps)]
    jopt = _jax_optimizer(kind, lr, norm_clipping, value_clipping, grad_accum)
    popt = _port_optimizer(kind, lr, norm_clipping, value_clipping, grad_accum)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    pparams = params_from_jax(params)
    pstate = popt.init(pparams)
    for g in grads:
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        pupdates, pstate = popt.update(params_from_jax(g), pstate, pparams)
        pparams = {k: v + pupdates[k] for k, v in pparams.items()}
    return jparams, jstate, pparams, pstate, popt


def _assert_trees_close(got, want, rtol=1e-6, atol=1e-6):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        assert np.shape(a) == np.shape(b), path
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("norm_clipping", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("kind", [o.value for o in Optimizers])
def test_three_updates_match_optax(kind, norm_clipping):
    jparams, jstate, pparams, pstate, popt = _run_both(kind, norm_clipping)
    _assert_trees_close(params_to_jax(pparams), jax.device_get(jparams))
    # the state, mapped to optax's layout, holds the same values
    _assert_trees_close(popt.state_dict(pstate), serialization.to_state_dict(jax.device_get(jstate)))


def test_value_clipping_matches_optax():
    jparams, jstate, pparams, pstate, popt = _run_both("adam", True, value_clipping=True)
    _assert_trees_close(params_to_jax(pparams), jax.device_get(jparams))
    _assert_trees_close(popt.state_dict(pstate), serialization.to_state_dict(jax.device_get(jstate)))


def test_multisteps_k2_matches_optax():
    jparams, jstate, pparams, pstate, popt = _run_both("adam", True, steps=5, grad_accum=2)
    _assert_trees_close(params_to_jax(pparams), jax.device_get(jparams))
    _assert_trees_close(popt.state_dict(pstate), serialization.to_state_dict(jax.device_get(jstate)))


@pytest.mark.parametrize("warmup", [0, 3])
def test_cosine_warmup_lr_matches_optax(warmup):
    kwargs = dict(init_value=0.0 if warmup else 1e-3, peak_value=1e-3, warmup_steps=warmup,
                  decay_steps=8, end_value=1e-4)
    jopt = optax.inject_hyperparams(lambda learning_rate: optax.sgd(learning_rate))(
        learning_rate=optax.warmup_cosine_decay_schedule(**kwargs))
    popt = Optimizers.SGD.make(warmup_cosine_decay_schedule(**kwargs), norm_clipping=False)
    g = {"w": {"kernel": np.ones((1, 1, 1, 2), np.float32), "bias": np.ones(2, np.float32)}}
    jstate = jopt.init(jax.tree_util.tree_map(jnp.asarray, g))
    pstate = popt.init(params_from_jax(g))
    jlr, plr = [], []
    for _ in range(10):
        _, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate)
        _, pstate = popt.update(params_from_jax(g), pstate, params_from_jax(g))
        jlr.append(float(jstate.hyperparams["learning_rate"]))
        plr.append(popt.current_lr(pstate))
    np.testing.assert_allclose(plr, jlr, rtol=0, atol=1e-7)
    # and within two float32 ulps (XLA's cos and torch's may differ by one)
    np.testing.assert_array_max_ulp(np.float32(plr), np.float32(jlr), maxulp=2)
    assert jlr[-1] == pytest.approx(1e-4, rel=1e-5)


def _saved_pair(tmp_path, grad_accum):
    """The JAX package's checkpoint with an optimizer state after two
    updates, and the port's of the same state values."""
    jparams, jstate, _, _, popt = _run_both("adam", True, steps=2, value_clipping=True,
                                            grad_accum=grad_accum)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    meta = {"architecture": "fcn_skip", "epoch": 1}
    jax_checkpoint.save_checkpoint(jax_dir, {"params": jparams}, meta=meta, opt_state=jstate)
    state_dict = jax_checkpoint.load_opt_state(jax_dir)
    port_state = popt.load_state_dict(state_dict, torch.device("cpu"))
    port_checkpoint.save_checkpoint(port_dir, {"params": params_to_jax(params_from_jax(
        jax.device_get(jparams)))}, meta=meta, opt_state=popt.state_dict(port_state))
    return jax_dir, port_dir, jstate, popt, port_state


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_opt_state_file_is_byte_identical(tmp_path, grad_accum):
    jax_dir, port_dir, *_ = _saved_pair(tmp_path, grad_accum)
    for name in ("opt_state.msgpack", "params.msgpack", "meta.json"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def test_each_package_reads_the_others_opt_state(tmp_path):
    jax_dir, port_dir, jstate, popt, port_state = _saved_pair(tmp_path, 1)
    from_port = jax_checkpoint.load_opt_state(port_dir, template=jstate)
    _assert_trees_close(serialization.to_state_dict(from_port),
                        serialization.to_state_dict(jax.device_get(jstate)), rtol=0, atol=0)
    from_jax = port_checkpoint.load_opt_state(jax_dir, template=popt.state_dict(port_state))
    restored = popt.load_state_dict(from_jax, torch.device("cpu"))
    _assert_trees_close(popt.state_dict(restored), popt.state_dict(port_state), rtol=0, atol=0)
    assert port_checkpoint.load_meta(jax_dir) == jax_checkpoint.load_meta(port_dir)
    # a state of another optimizer does not fit the template
    with pytest.raises(ValueError, match="template"):
        port_checkpoint.load_opt_state(jax_dir, template=Optimizers.SGD.make(1e-3).state_dict(
            Optimizers.SGD.make(1e-3).init(params_from_jax(_tree(np.random.default_rng(0))))))


def test_params_to_jax_inverts_params_from_jax():
    tree = _tree(np.random.default_rng(5))
    back = params_to_jax(params_from_jax(tree))
    _assert_trees_close(back, tree, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["adam", "nadam", "adamax", "adadelta", "adagrad", "rmsprop", "sgd"])
def test_an_update_makes_no_tensor_from_host_data(kind):
    """An update runs on the device alone: a tensor made from a host value
    (``aten.lift_fresh``, ``torch.tensor(x, device=...)``) is, on the card,
    a copy that waits for everything launched before it, once a step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(str(func))
            return func(*args, **(kwargs or {}))

    optimizer = Optimizers(kind).make(1e-3)
    params = params_from_jax(_tree(np.random.default_rng(0)))
    grads = params_from_jax(_tree(np.random.default_rng(1)))
    state = optimizer.init(params)
    with Ops() as ops:
        for _ in range(2):
            updates, state = optimizer.update(grads, state, params)
    assert ops.seen and not {op for op in ops.seen if "lift_fresh" in op}, sorted(ops.seen)
