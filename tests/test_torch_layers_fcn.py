"""The port's layers, FCN models and weights bridge against the flax modules
on the same inputs and weights.

Tolerances: float32 outputs agree to atol 1e-4 (the two frameworks sum the
convolutions in another order); bf16 is gated on argmax agreement >= 99.9 %
(the repo's parity bar, BASELINE.md), since bf16 rounds at other places in
the two frameworks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.models import fcn as jax_fcn
from page_segmentation_tpu.models import layers as jax_layers
from page_segmentation_tpu_torch.models import fcn as torch_fcn
from page_segmentation_tpu_torch.models import layers as torch_layers
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("k", [5, 1])
def test_tfconv_matches_flax(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 12, 10, 3)).astype(np.float32)
    module = jax_layers.TFConv(4, (k, k), activation=jax_layers.relu)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": rng.standard_normal(4).astype(np.float32)}
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))

    layer = torch_layers.TFConv(3, 4, (k, k), relu=True)
    layer.load_state_dict({n.split(".")[1]: t for n, t in
                           params_from_jax({"l": params}).items()})
    np.testing.assert_allclose(_nhwc(layer(_nchw(x))), want, atol=1e-4)


@pytest.mark.parametrize("k,s", [(5, 1), (2, 2), (3, 2)])
def test_tfconv_transpose_matches_flax(k, s):
    rng = np.random.default_rng(10 * k + s)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    module = jax_layers.TFConvTranspose(4, (k, k), strides=(s, s))
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = {"kernel": params["kernel"],
              "bias": rng.standard_normal(4).astype(np.float32)}
    want = np.asarray(module.apply({"params": params}, jnp.asarray(x)))

    layer = torch_layers.TFConvTranspose(3, 4, (k, k), (s, s))
    layer.load_state_dict({n.split(".")[1]: t for n, t in
                           params_from_jax({"l": params}).items()})
    got = _nhwc(layer(_nchw(x)))
    assert got.shape == want.shape == (2, 7 * s, 9 * s, 4)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("shape", [(1, 6, 8, 2), (2, 5, 7, 3)])
def test_max_pool_same_matches_flax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jax_layers.max_pool_same(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(torch_layers.max_pool_same(_nchw(x))), want)


def _models(cls_name, n_classes=3, seed=0, dtype="float32"):
    tree = init_params_numpy(n_classes, seed)
    if cls_name == "FCN":  # no skip concats: narrower decoder inputs
        tree["deconv3"]["kernel"] = tree["deconv3"]["kernel"][..., :60]
        tree["deconv4"]["kernel"] = tree["deconv4"]["kernel"][..., :40]
        tree["deconv5"]["kernel"] = tree["deconv5"]["kernel"][..., :30]
        tree["logits"]["kernel"] = tree["logits"]["kernel"][:, :, :20]
    rng = np.random.default_rng(seed + 1)
    for leaves in tree.values():  # nonzero biases exercise the bias path
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    jax_module = getattr(jax_fcn, cls_name)(n_classes=n_classes, dtype=getattr(jnp, dtype))
    torch_module = getattr(torch_fcn, cls_name)(n_classes, dtype=getattr(torch, dtype))
    torch_module.load_state_dict(params_from_jax(tree))
    return jax_module, {"params": tree}, torch_module


def _page_batch(shape, seed=0):
    """Page-like input in [0, 1]: paper, dark glyph blocks, noise."""
    n, h, w = shape
    rng = np.random.default_rng(seed)
    img = np.full((n, h, w), 0.08, np.float32)
    for _ in range(12):
        i, y, x = rng.integers(0, n), rng.integers(0, h - 6), rng.integers(0, w - 6)
        img[i, y : y + 6, x : x + rng.integers(3, 7)] = rng.uniform(0.7, 0.95)
    img += 0.02 * rng.standard_normal(img.shape).astype(np.float32)
    return img[..., None]


@pytest.mark.parametrize("cls_name", ["FCNSkip", "FCN"])
def test_fcn_float32_logits_match_jax(cls_name):
    jax_module, variables, torch_module = _models(cls_name)
    x = _page_batch((2, 64, 48))
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x)))
    got = torch_module(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 64, 48, 3)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fcn_skip_bf16_argmax_agreement():
    jax_module, variables, torch_module = _models("FCNSkip", dtype="bfloat16")
    x = _page_batch((2, 64, 48), seed=3)
    want = np.asarray(jax_module.apply(variables, jnp.asarray(x, jnp.bfloat16))).argmax(-1)
    logits = torch_module(torch.from_numpy(x).to(torch.bfloat16))
    assert logits.dtype == torch.float32
    agreement = (logits.argmax(-1).numpy() == want).mean()
    assert agreement >= 0.999, f"bf16 argmax agreement {agreement:.5f}"


def test_bridge_round_trip_names_and_shapes():
    module = jax_fcn.FCNSkip(n_classes=3)
    flax_shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))["params"])
    tree = init_params_numpy(3, seed=7)
    assert set(tree) == set(flax_shapes)
    for name in flax_shapes:
        for leaf in ("kernel", "bias"):
            assert tree[name][leaf].shape == flax_shapes[name][leaf].shape, (name, leaf)

    state = params_from_jax({"params": tree})
    torch_module = torch_fcn.FCNSkip(3)
    assert set(state) == set(torch_module.state_dict())
    torch_module.load_state_dict(state, strict=True)
    for name in tree:
        back = getattr(torch_module, name).weight.detach().numpy().transpose(2, 3, 1, 0)
        np.testing.assert_array_equal(back, tree[name]["kernel"])
        np.testing.assert_array_equal(getattr(torch_module, name).bias.detach().numpy(),
                                      tree[name]["bias"])


def test_init_params_numpy_is_seeded_glorot():
    a, b, c = init_params_numpy(3, 0), init_params_numpy(3, 0), init_params_numpy(3, 1)
    np.testing.assert_array_equal(a["conv3"]["kernel"], b["conv3"]["kernel"])
    assert not np.array_equal(a["conv3"]["kernel"], c["conv3"]["kernel"])
    limit = np.sqrt(6.0 / ((30 + 40) * 25))
    assert np.abs(a["conv3"]["kernel"]).max() <= limit
    assert not a["conv3"]["bias"].any()


def test_s2d_stem_not_ported():
    """The s2d stem is ported (tests/test_torch_s2d.py): it builds, and its
    forward equals the dense stem's."""
    fast, dense = torch_fcn.FCNSkip(3, s2d_stem=True), torch_fcn.FCNSkip(3)
    gen = torch.Generator().manual_seed(0)
    state = {k: 0.1 * torch.randn(v.shape, generator=gen) for k, v in dense.state_dict().items()}
    fast.load_state_dict(state)
    dense.load_state_dict(state)
    x = torch.rand(1, 1, 16, 24, generator=gen)
    with torch.no_grad():
        torch.testing.assert_close(fast.forward_nchw(x), dense.forward_nchw(x), atol=1e-4, rtol=1e-4)
    assert fast.s2d_runs == 1
