"""The port's space-to-depth stem (``models/s2d.py``, ``FCNSkip``/``FCN``
with ``s2d_stem=True``) against the JAX package's, on the CPU.

The reindexing (space_to_depth, depth_to_space, the kernel gather and the
bias tiling) must equal the JAX functions' exactly, in the port's layouts
(NCHW, (out, in, kh, kw)).  The models share weights through the bridge:
float32 logits within 1e-4 of the JAX s2d models' and argmax equal; port s2d
vs port dense the same; shapes that are not multiples of 4 take the dense
stem; the state dict is the same with the flag on or off; gradients equal
the dense stem's within 1e-4 relative in norm."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.models import fcn as jax_fcn
from page_segmentation_tpu.models import s2d as jax_s2d
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models import s2d
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
from page_segmentation_tpu_torch.models.fcn import FCN, FCNSkip
from page_segmentation_tpu_torch.models.registry import Architecture

MODELS = {"fcn_skip": (FCNSkip, jax_fcn.FCNSkip, True), "fcn": (FCN, jax_fcn.FCN, False)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def _nhwc(x):
    return np.asarray(x).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (1, 8, 8, 20)])
def test_space_to_depth_and_back_equal_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    packed = s2d.space_to_depth(_nchw(x), 4)
    np.testing.assert_array_equal(_nhwc(packed), np.asarray(jax_s2d.space_to_depth(jnp.asarray(x), 4)))
    np.testing.assert_array_equal(s2d.depth_to_space(packed, 4).numpy(), _nchw(x).numpy())
    np.testing.assert_array_equal(
        _nhwc(s2d.depth_to_space(packed, 4)),
        np.asarray(jax_s2d.depth_to_space(jax_s2d.space_to_depth(jnp.asarray(x), 4), 4)))


@pytest.mark.parametrize("cin, cout", [(1, 20), (20, 30), (3, 7)])
def test_kernel_gather_and_bias_equal_jax(cin, cout):
    rng = np.random.default_rng(1)
    kernel = rng.standard_normal((5, 5, cin, cout)).astype(np.float32)  # HWIO
    bias = rng.standard_normal(cout).astype(np.float32)
    got = s2d.s2d_conv_kernel(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()), 4)
    want = np.asarray(jax_s2d.s2d_conv_kernel(jnp.asarray(kernel), 4))  # (A, A, 16cin, 16cout)
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(s2d.s2d_bias(torch.from_numpy(bias), 4).numpy(),
                                  np.asarray(jax_s2d.s2d_bias(jnp.asarray(bias), 4)))
    for k in (3, 5, 7):
        got_maps, want_maps = s2d._phase_maps(k, 4), jax_s2d._phase_maps(k, 4)
        for a, b in zip(got_maps, want_maps):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_s2d_models_match_jax_and_dense(name):
    cls, jax_cls, skips = MODELS[name]
    params = init_params_numpy(3, 0, skips=skips)
    x = np.random.default_rng(2).random((2, 48, 64, 1)).astype(np.float32)
    want = np.asarray(jax_cls(n_classes=3, s2d_stem=True).apply({"params": params}, x))
    fast, dense = cls(3, s2d_stem=True), cls(3)
    fast.load_state_dict(params_from_jax(params))
    dense.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got, plain = fast(torch.from_numpy(x)).numpy(), dense(torch.from_numpy(x)).numpy()
    assert fast.s2d_runs == 1 and dense.s2d_runs == 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, plain, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), plain.argmax(-1))


def test_bf16_s2d_stem_matches_jax_on_decisive_pixels():
    params = init_params_numpy(3, 0)
    x = np.random.default_rng(3).random((2, 48, 64, 1)).astype(np.float32)
    want = np.asarray(jax_fcn.FCNSkip(n_classes=3, dtype=jnp.bfloat16, s2d_stem=True)
                      .apply({"params": params}, x))
    ref = np.asarray(jax_fcn.FCNSkip(n_classes=3).apply({"params": params}, x))
    fast = FCNSkip(3, dtype=torch.bfloat16, s2d_stem=True)
    fast.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        got = fast(torch.from_numpy(x)).numpy()
    top2 = np.sort(ref, -1)[..., -2:]
    decisive = top2[..., 1] - top2[..., 0] >= 0.05 * np.abs(ref).max()
    assert decisive.mean() > 0.3
    assert (got.argmax(-1) == want.argmax(-1))[decisive].mean() >= 0.999


def test_odd_shapes_take_the_dense_stem():
    assert not s2d.stem_applicable((1, 1, 37, 53)) and s2d.stem_applicable((1, 1, 40, 56))
    params = params_from_jax(init_params_numpy(3, 0))
    fast, dense = FCNSkip(3, s2d_stem=True), FCNSkip(3)
    fast.load_state_dict(params)
    dense.load_state_dict(params)
    x = torch.from_numpy(np.random.default_rng(4).random((1, 1, 37, 53)).astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(fast._stem(x).numpy(), dense._stem(x).numpy())
    assert fast.s2d_runs == 0


def test_state_dict_is_the_same_with_the_flag():
    for arch in (Architecture.FCN_SKIP, Architecture.FCN):
        dense, fast = arch.model(3), arch.model(3, s2d_stem=True)
        assert fast.s2d_stem and not dense.s2d_stem
        assert {k: v.shape for k, v in dense.state_dict().items()} == \
            {k: v.shape for k, v in fast.state_dict().items()}
        fast.load_state_dict(dense.state_dict())  # strict


def test_classifier_s2d_predicts_as_dense():
    dense = PixelClassifier(3, device="cpu", seed=1)
    fast = PixelClassifier(3, device="cpu", seed=1, s2d_stem=True)
    from page_segmentation_tpu_torch.data.dataset import SingleData

    rng = np.random.default_rng(7)
    data = SingleData(image=rng.integers(0, 256, (41, 59)).astype(np.uint8),
                      binary=np.ones((41, 59), np.uint8))
    logit_d, _, pred_d = dense.predict_single_data(data)
    logit_f, _, pred_f = fast.predict_single_data(data)
    assert fast.module.s2d_runs == 1
    np.testing.assert_array_equal(pred_f, pred_d)
    np.testing.assert_allclose(logit_f, logit_d, rtol=1e-4, atol=1e-4)


def test_gradients_match_the_dense_stem():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((1, 1, 32, 32)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 3, (1, 32, 32)))
    params = params_from_jax(init_params_numpy(3, 0))
    grads = []
    for flag in (False, True):
        model = FCNSkip(3, s2d_stem=flag)
        model.load_state_dict(params)
        loss = torch.nn.functional.cross_entropy(model.forward_nchw(x), target)
        grads.append(dict(zip([n for n, _ in model.named_parameters()],
                              torch.autograd.grad(loss, list(model.parameters())))))
    dense, fast = grads
    assert fast.keys() == dense.keys()
    for name in dense:
        err = torch.linalg.vector_norm(fast[name] - dense[name])
        assert err <= 1e-4 * torch.linalg.vector_norm(dense[name]) + 1e-12, name


def test_cli_s2d_stem_predicts_as_dense(tmp_path):
    from page_segmentation_tpu_torch.cli.main import main
    from page_segmentation_tpu_torch.core.image_io import imread, imsave
    from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

    for sub in ("images", "binary"):
        (tmp_path / sub).mkdir()
    for i in range(2):
        page = np.full((64, 48), 235, np.uint8)
        page[16:40, 8 + 4 * i : 30 + 4 * i] = 30
        imsave(tmp_path / "images" / f"p{i}.png", page)
        imsave(tmp_path / "binary" / f"p{i}.png", np.where(page >= 128, 255, 0).astype(np.uint8))
    ckpt = str(tmp_path / "model")
    save_checkpoint(ckpt, {"params": init_params_numpy(3, 0)}, {"architecture": "fcn_skip"})
    common = ["predict", "--device", "cpu", "--load", ckpt, "--images", str(tmp_path / "images"),
              "--binary", str(tmp_path / "binary"), "--char_height", "6", "--fast"]
    assert main(common + ["--output", str(tmp_path / "s2d"), "--s2d_stem"]) == 0
    assert main(common + ["--output", str(tmp_path / "dense")]) == 0
    for i in range(2):
        np.testing.assert_array_equal(imread(tmp_path / "s2d" / "color" / f"p{i}.png"),
                                      imread(tmp_path / "dense" / "color" / f"p{i}.png"))
