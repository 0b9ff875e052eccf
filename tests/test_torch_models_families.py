"""The port's model families and their layers against the flax modules, on
the same inputs and the same weights (carried across by the bridge).

Tolerances: layer outputs agree to atol 1e-5 (two frameworks sum in
another order); bf16 BatchNorm outputs to one bf16 rounding.  Every one of
the 14 names builds with flax's variable tree."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax import lax

from page_segmentation_tpu import utils as jax_utils
from page_segmentation_tpu.models import layers as jax_layers
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu_torch import utils
from page_segmentation_tpu_torch.models import layers
from page_segmentation_tpu_torch.models.bridge import (
    init_variables_numpy,
    params_from_jax,
    params_to_jax,
    zero_variables,
)
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.ops.prng import prng_key
from tests.torch_families import size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several test processes share the cores; torch's own pool would
    # oversubscribe them
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _load(layer, leaves):
    layer.load_state_dict({n.split(".", 1)[1]: t for n, t in params_from_jax({"l": leaves}).items()})


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("k, s, h, w, groups", [
    (3, 2, 8, 8, 1), (3, 2, 7, 9, 1), (5, 2, 8, 10, 1), (1, 2, 8, 8, 1), (7, 2, 10, 9, 1),
    (2, 1, 6, 7, 1), (3, 2, 8, 8, 4), (5, 2, 9, 8, 4), (3, 1, 6, 6, 4), (5, 1, 7, 6, 4),
])
def test_tfconv_same_matches_lax(k, s, h, w, groups):
    """TF's SAME padding puts the odd pixel after: 3x3/2 on an even side
    pads (0, 1), 5x5/2 pads (1, 2); groups = channels is the depthwise conv."""
    rng = np.random.default_rng(k * 100 + s * 10 + groups)
    x = rng.standard_normal((2, h, w, 4)).astype(np.float32)
    kernel = rng.standard_normal((k, k, 4 // groups, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(kernel), (s, s), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups)) + bias
    layer = layers.TFConv(4, 4, (k, k), strides=(s, s), groups=groups)
    _load(layer, {"kernel": kernel, "bias": bias})
    got = _nhwc(layer(_nchw(x)))
    assert got.shape == want.shape == (2, -(-h // s), -(-w // s), 4)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_tfconv_explicit_pad_and_valid_match_lax():
    """ResNet's stem: a 3-pixel zero pad then a VALID 7x7/2 conv; and a
    bias-free VALID 1x1/2 conv."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 12, 10, 3)).astype(np.float32)
    k7 = rng.standard_normal((7, 7, 3, 5)).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(
        jnp.pad(jnp.asarray(x), ((0, 0), (3, 3), (3, 3), (0, 0))), jnp.asarray(k7), (2, 2), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC")))
    stem = layers.TFConv(3, 5, (7, 7), strides=(2, 2), padding=3)
    _load(stem, {"kernel": k7, "bias": np.zeros(5, np.float32)})
    np.testing.assert_allclose(_nhwc(stem(_nchw(x))), want, atol=1e-5)

    k1 = rng.standard_normal((1, 1, 3, 5)).astype(np.float32)
    want = np.asarray(lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k1), (2, 2), "VALID",
                                               dimension_numbers=("NHWC", "HWIO", "NHWC")))
    valid = layers.TFConv(3, 5, (1, 1), strides=(2, 2), padding="VALID", use_bias=False)
    assert valid.bias is None
    _load(valid, {"kernel": k1})
    np.testing.assert_allclose(_nhwc(valid(_nchw(x))), want, atol=1e-5)


@pytest.mark.parametrize("momentum, epsilon", [(0.99, 1.001e-5), (0.999, 1e-3), (0.99, 1e-3)])
def test_batchnorm_matches_flax(momentum, epsilon):
    """Training mode: the batch's biased E[x²] - E[x]² statistics normalize,
    and the running statistics become m * ra + (1 - m) * batch; eval mode
    normalizes with the running statistics."""
    rng = np.random.default_rng(int(momentum * 1000))
    x = (3.0 + 2.0 * rng.standard_normal((3, 5, 4, 6))).astype(np.float32)
    leaves = {"scale": rng.uniform(0.5, 1.5, 6).astype(np.float32),
              "bias": rng.standard_normal(6).astype(np.float32)}
    stats = {"mean": rng.standard_normal(6).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 6).astype(np.float32)}
    flax_bn = nn.BatchNorm(momentum=momentum, epsilon=epsilon)
    variables = {"params": leaves, "batch_stats": stats}
    want_train, mutated = flax_bn.apply(variables, jnp.asarray(x), use_running_average=False,
                                        mutable=["batch_stats"])
    want_eval = flax_bn.apply(variables, jnp.asarray(x), use_running_average=True)

    bn = layers.BatchNorm(6, momentum=momentum, epsilon=epsilon)
    bn.load_state_dict({n.split(".", 1)[1]: t for n, t in
                        params_from_jax({"params": {"l": leaves}, "batch_stats": {"l": stats}}).items()})
    bn.train()
    np.testing.assert_allclose(_nhwc(bn(_nchw(x))), np.asarray(want_train), atol=1e-5)
    new_mean, new_var = bn.updated_stats
    np.testing.assert_allclose(new_mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]), rtol=1e-6)
    np.testing.assert_allclose(new_var.numpy(), np.asarray(mutated["batch_stats"]["var"]), rtol=1e-5)
    bn.eval()
    np.testing.assert_allclose(_nhwc(bn(_nchw(x))), np.asarray(want_eval), atol=1e-5)


def test_batchnorm_bf16_normalizes_in_float32_like_flax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    stats = {"mean": rng.standard_normal(3).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 3).astype(np.float32)}
    leaves = {"scale": np.full(3, 1.5, np.float32), "bias": np.full(3, 0.25, np.float32)}
    want = nn.BatchNorm(use_running_average=True, dtype=jnp.bfloat16).apply(
        {"params": leaves, "batch_stats": stats}, jnp.asarray(x, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    bn = layers.BatchNorm(3, dtype=torch.bfloat16).eval()
    bn.load_state_dict({n.split(".", 1)[1]: t for n, t in
                        params_from_jax({"params": {"l": leaves}, "batch_stats": {"l": stats}}).items()})
    got = bn(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the same float32 value (1 ulp where rsqrt differs)
    np.testing.assert_allclose(_nhwc(got.float()), np.asarray(want.astype(jnp.float32)), rtol=2 ** -7)


def test_upsample_pool_and_channel_helpers_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(layers.upsample2x(_nchw(x))),
                                  np.asarray(jax_layers.upsample2x(jnp.asarray(x))))
    # ResNet's pool1: a -inf 1-pixel pad and a VALID 3x3/2 max pool
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf)
    want = lax.reduce_window(padded, -jnp.inf, lax.max, (1, 3, 3, 1), (1, 2, 2, 1), "VALID")
    got = torch.nn.functional.max_pool2d(_nchw(x), 3, 2, padding=1)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))
    gray = x[..., :1]
    np.testing.assert_array_equal(layers.gray_to_rgb(torch.from_numpy(gray)).numpy(),
                                  np.asarray(jax_layers.gray_to_rgb(jnp.asarray(gray))))
    np.testing.assert_array_equal(layers.GrayToRgb()(torch.from_numpy(gray)).numpy(),
                                  np.asarray(jax_layers.GrayToRgb().apply({}, jnp.asarray(gray))))
    np.testing.assert_array_equal(layers.Padding2D((2, 3))(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_layers.Padding2D((2, 3)).apply({}, jnp.asarray(x))))
    page = rng.integers(0, 256, (6, 5)).astype(np.uint8)
    for img in (page, page[..., None], np.stack([page] * 3, -1)):
        np.testing.assert_array_equal(utils.gray_to_rgb(img), jax_utils.gray_to_rgb(img))
        np.testing.assert_array_equal(utils.image_to_batch(img), jax_utils.image_to_batch(img))
    np.testing.assert_array_equal(utils.preserving_resize(page, (9, 4)),
                                  jax_utils.preserving_resize(page, (9, 4)))


def test_dropout_keep_rate_scale_and_seeded_reproducibility():
    x = torch.ones((1, 1, 400, 500))
    a = layers.dropout(x, 0.5, prng_key(3))
    kept = a != 0
    assert abs(float(kept.float().mean()) - 0.5) < 0.01
    assert torch.equal(a[kept], torch.full((int(kept.sum()),), 2.0))  # 1 / (1 - p)
    assert torch.equal(a, layers.dropout(x, 0.5, prng_key(3)))
    assert not torch.equal(a, layers.dropout(x, 0.5, prng_key(4)))
    q = layers.dropout(x, 0.25, prng_key(3))
    assert abs(float((q != 0).float().mean()) - 0.75) < 0.01 and float(q.max()) == pytest.approx(4 / 3)

    unet = Architecture.UNET.model(2)
    unet.load_state_dict(params_from_jax(init_variables_numpy(unet, 0)))
    page = torch.rand((1, 32, 32, 1), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        plain = unet(page)
        assert torch.equal(plain, unet(page, prng_key(1)))  # eval: no dropout
        unet.train()
        first = unet(page, prng_key(1))
        assert torch.equal(first, unet(page, prng_key(1)))
        assert not torch.equal(first, plain)
        assert torch.equal(unet(page), plain)  # no key: no dropout
        unet.eval()


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch", list(Architecture), ids=lambda a: a.value)
def test_module_trees_match_flax(arch):
    """Every name builds; its variables have flax's tree, names and shapes,
    and the bridge is an exact round trip."""
    jax_module = JaxArchitecture(arch.value).model(3)
    channels = 3 if arch.preprocess()[1] else 1
    want = jax.eval_shape(lambda: jax_module.init(
        jax.random.PRNGKey(0), jnp.zeros((1,) + size(arch) + (channels,))))
    with torch.device("meta"):
        module = arch.model(3)
    variables = init_variables_numpy(module, seed=0)
    assert jax.tree_util.tree_map(lambda a: a.shape, variables) == \
        jax.tree_util.tree_map(lambda s: s.shape, dict(want))
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(lambda a: not a.any(), zero_variables(module)))
    if arch in (Architecture.UNET, Architecture.MOBILE_NET, Architecture.EFFNETB0):
        state = params_from_jax(variables)
        assert set(state) == set(arch.model(3).state_dict())
        back = params_to_jax(state)
        back = back if "params" in back else {"params": back}
        assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, variables))


def test_init_variables_numpy_is_seeded_glorot():
    module = Architecture.MOBILE_NET.model(3)
    a, b, c = (init_variables_numpy(module, s) for s in (0, 0, 1))
    dw = a["params"]["encoder"]["block_1"]["depthwise"]["dwconv"]["kernel"]
    assert dw.shape == (3, 3, 1, 96)
    assert np.abs(dw).max() <= np.sqrt(6.0 / ((1 + 96) * 9))  # flax's fans for (kh, kw, 1, C)
    np.testing.assert_array_equal(dw, b["params"]["encoder"]["block_1"]["depthwise"]["dwconv"]["kernel"])
    assert not np.array_equal(dw, c["params"]["encoder"]["block_1"]["depthwise"]["dwconv"]["kernel"])
    bn = a["params"]["encoder"]["stem"]["bn"]
    stats = a["batch_stats"]["encoder"]["stem"]["bn"]
    assert (bn["scale"] == 1).all() and not bn["bias"].any()
    assert not stats["mean"].any() and (stats["var"] == 1).all()


def test_s2d_stem_still_raises():
    """The other families ignore ``s2d_stem``, as the JAX modules do (the
    flag is ported for fcn/fcn_skip: tests/test_torch_s2d.py)."""
    plain, flagged = Architecture.UNET.model(3), Architecture.UNET.model(3, s2d_stem=True)
    assert type(flagged) is type(plain) and flagged.state_dict().keys() == plain.state_dict().keys()
