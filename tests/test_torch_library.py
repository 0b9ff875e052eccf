"""The port's per-page library predict path (DatasetLoader -> PixelClassifier
-> Predictor, with the host and device cc-vote) against the JAX package's,
on the same inputs and the same weights, on the CPU.

Tolerances: host functions (padding, resizes, preparation, PNG pixels,
components, masks, votes, checkpoint arrays) are exactly equal.  float32
logits agree to atol 1e-4 and the argmax on >= 99.99 % of pixels (the two
frameworks sum the convolutions in another order); bf16 class maps agree on
>= 99.9 % of pixels (bf16 rounds at other places), and every product of the
labels is byte-equal wherever the labels agree.  The device resample agrees
to 0.01 gray levels (two cubic resamplers)."""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core import image_io as jax_io
from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP as JAX_MAP
from page_segmentation_tpu.data import dataset as jax_dataset
from page_segmentation_tpu.data import prepare as jax_prepare
from page_segmentation_tpu.data.loader import DatasetLoader as JaxLoader
from page_segmentation_tpu.inference import output as jax_output
from page_segmentation_tpu.inference import postprocess as jax_post
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.inference.predictor import Predictor as JaxPredictor
from page_segmentation_tpu.inference.predictor import PredictSettings as JaxSettings
from page_segmentation_tpu.models import registry as jax_registry
from page_segmentation_tpu.ops import cc as jax_cc
from page_segmentation_tpu.ops import pad as jax_pad
from page_segmentation_tpu.ops import resize as jax_resize
from page_segmentation_tpu.train.checkpoint import save_checkpoint
from page_segmentation_tpu_torch.core import image_io
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.data import prepare
from page_segmentation_tpu_torch.data.dataset import Dataset, SingleData
from page_segmentation_tpu_torch.data.loader import DatasetLoader
from page_segmentation_tpu_torch.inference import output, postprocess
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
from page_segmentation_tpu_torch.models import registry
from page_segmentation_tpu_torch.models.bridge import init_params_numpy
from page_segmentation_tpu_torch.ops import cc, pad, resize
from page_segmentation_tpu_torch.train.checkpoint import load_checkpoint

PALETTE = DEFAULT_IMAGE_MAP.palette


def _page(h, w, seed):
    """A page at '300 DPI' with 16 px text lines: (gray page, 0/255 binary)."""
    rng = np.random.RandomState(seed)
    page = np.full((h, w), 235, np.uint8)
    for row in range(8, h - 20, 26):
        for col in range(6, w - 24, 30):
            if rng.rand() < 0.8:
                page[row : row + 16, col : col + 20] = rng.randint(10, 60)
    page[-18:-4, 4:w // 2] = 120  # a figure strip
    noise = rng.randint(-6, 7, page.shape)
    page = np.clip(page.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    return page, np.where(page < 128, 0, 255).astype(np.uint8)


def _prepared(h, w, seed):
    page, binary = _page(h, w, seed)
    img, bin_scaled = prepare.prepare_images(page, binary, 6, 16)
    return img, bin_scaled


@pytest.fixture(scope="module")
def weights():
    tree = init_params_numpy(3, seed=0)
    rng = np.random.default_rng(1)
    for leaves in tree.values():  # nonzero biases exercise the bias path
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    return tree


def _classifiers(weights, dtype):
    jax_cls = JaxClassifier(n_classes=3, compute_dtype=getattr(jnp, dtype))
    jax_cls.params = weights
    port = PixelClassifier(3, compute_dtype=getattr(torch, dtype), device="cpu")
    port.params = weights
    return jax_cls, port


@pytest.fixture(scope="module")
def float32_pair(weights):
    return _classifiers(weights, "float32")


@pytest.fixture(scope="module")
def bf16_pair(weights):
    return _classifiers(weights, "bfloat16")


# ------------------------------------------------------------- host functions
@pytest.mark.parametrize("shape,factor,gran", [((37, 53), 8, 1), ((64, 48), 8, 2), ((421, 298), 32, 1)])
def test_pad_helpers_match_jax(shape, factor, gran):
    assert pad.padding_for(shape, factor) == jax_pad.padding_for(shape, factor)
    target = pad.bucket_shape(shape, factor, gran)
    assert target == jax_pad.bucket_shape(shape, factor, gran)
    rng = np.random.default_rng(0)
    for image in (rng.integers(0, 255, shape, dtype=np.uint8),
                  rng.random(shape + (3,)).astype(np.float32)):
        got = pad.pad_to(image, target, value=7)
        np.testing.assert_array_equal(got, jax_pad.pad_to(image, target, value=7))
        np.testing.assert_array_equal(pad.crop_to(got, shape), jax_pad.crop_to(got, shape))


_HOST_RESIZES = {
    "nearest": lambda m, img, s: m.resize_nearest(img, s),
    "rescale_nearest": lambda m, img, s: m.rescale_nearest(img, 0.37),
    "cubic": lambda m, img, s: m.resize_cubic(img.astype(np.float64), s),
    "cubic_aa": lambda m, img, s: m.resize_cubic(img.astype(np.float64), s, anti_aliasing=True),
    "cubic_pil": lambda m, img, s: m.resize_cubic_fast(img, s),
}


@pytest.mark.parametrize("name", sorted(_HOST_RESIZES))
@pytest.mark.parametrize("out_shape", [(23, 17), (90, 71)])
def test_host_resizes_match_jax(name, out_shape):
    img = _page(61, 45, 0)[0]
    fn = _HOST_RESIZES[name]
    np.testing.assert_array_equal(fn(resize, img, out_shape), fn(jax_resize, img, out_shape))
    assert resize.output_shape_for_scale(img.shape, 0.37) == jax_resize.output_shape_for_scale(img.shape, 0.37)


def test_device_resizes_match_jax():
    img = _page(61, 45, 1)[0]
    for out_shape in [(23, 17), (90, 71)]:
        np.testing.assert_array_equal(
            resize.resize_nearest_torch(torch.from_numpy(img), out_shape).numpy(),
            np.asarray(jax_resize.resize_nearest_jax(jnp.asarray(img), out_shape)))
        got = resize.resize_cubic_torch(torch.from_numpy(img).float(), out_shape).numpy()
        want = np.asarray(jax_resize.resize_cubic_jax(jnp.asarray(img, jnp.float32), out_shape))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 0.01


@pytest.mark.parametrize("backend", ["scipy", "pil"])
@pytest.mark.parametrize("max_width", [None, 14])
def test_prepare_images_matches_jax(backend, max_width):
    page, binary = _page(96, 80, 2)
    args = (page, binary, 6, 16, max_width, True, backend)
    for got, want in zip(prepare.prepare_images(*args), jax_prepare.prepare_images(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert prepare.prepared_shape(binary.shape, 6, 16, max_width) == \
        jax_prepare.prepared_shape(binary.shape, 6, 16, max_width)
    mask = np.random.default_rng(0).integers(0, 3, binary.shape).astype(np.uint8)
    np.testing.assert_array_equal(prepare.prepare_mask(mask, (30, 25)), jax_prepare.prepare_mask(mask, (30, 25)))


@pytest.fixture(scope="module")
def page_files(tmp_path_factory):
    """Two pages written as PNGs by the port; the second has no binary file
    (the loader thresholds the image)."""
    root = tmp_path_factory.mktemp("pages")
    entries = []
    for i, shape in enumerate([(96, 80), (70, 90)]):
        page, binary = _page(*shape, seed=10 + i)
        image_path = str(root / f"p{i}.png")
        image_io.imsave(image_path, page)
        binary_path = None
        if i == 0:
            binary_path = str(root / f"p{i}.bin.png")
            image_io.imsave(binary_path, binary)
        entries.append(dict(image_path=image_path, binary_path=binary_path, line_height_px=16))
    return entries


@pytest.mark.parametrize("binarize", ["threshold", "otsu"])
def test_loader_matches_jax(page_files, binarize):
    port = DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=True, binarize=binarize)
    jax_loader = JaxLoader(6, JAX_MAP, prediction=True, binarize=binarize)
    eager = port.load_data([SingleData(**e) for e in page_files])
    lazy = port.load_data([SingleData(**e) for e in page_files], lazy=True)
    want = jax_loader.load_data([jax_dataset.SingleData(**e) for e in page_files])
    for got_eager, got_lazy, w in zip(eager, lazy, want):
        assert got_lazy.image is None and got_lazy.prepared_shape == w.image.shape
        loaded = got_lazy.loader.load_lazy(got_lazy)
        for got in (got_eager, loaded):
            for field in ("image", "binary", "orig_binary"):
                np.testing.assert_array_equal(getattr(got, field), getattr(w, field))
            assert got.original_shape == w.original_shape
    # in-memory pages take the same path
    page, binary = _page(96, 80, 3)
    got = port.load_images(SingleData(image=page, binary=binary, line_height_px=16))
    w = jax_loader.load_images(jax_dataset.SingleData(image=page, binary=binary, line_height_px=16))
    np.testing.assert_array_equal(got.image, w.image)
    np.testing.assert_array_equal(got.binary, w.binary)


def test_loader_training_mode_raises(tmp_path):
    # training mode is ported (tests/test_torch_train_data.py); it raises
    # on an entry without a label mask and on a missing dataset JSON
    page, binary = _page(96, 80, 3)
    with pytest.raises(ValueError, match="mask"):
        DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=False).load_images(
            SingleData(image=page, binary=binary, line_height_px=16))
    with pytest.raises(FileNotFoundError):
        DatasetLoader(6, DEFAULT_IMAGE_MAP, prediction=True).load_data_from_json(
            [str(tmp_path / "missing.json")], "all")


def _images_to_write():
    rng = np.random.default_rng(5)
    return {
        "gray": rng.integers(0, 256, (13, 21), dtype=np.uint8),
        "rgb": rng.integers(0, 256, (13, 21, 3), dtype=np.uint8),
        "bool": rng.random((9, 14)) > 0.5,
        "float": rng.uniform(-20, 300, (7, 9)),
    }


@pytest.mark.parametrize("kind", ["gray", "rgb", "bool", "float"])
def test_port_pngs_decode_in_jax(tmp_path, kind):
    image = _images_to_write()[kind]
    path = str(tmp_path / "x.png")
    image_io.imsave(path, image)
    jax_path = str(tmp_path / "jax.png")
    jax_io.imsave(jax_path, image)
    want = jax_io.imread(jax_path, as_gray=image.ndim == 2)
    np.testing.assert_array_equal(jax_io.imread(path, as_gray=image.ndim == 2), want)
    for as_gray in (True, False):  # the port reads both writers' files alike
        np.testing.assert_array_equal(image_io.imread(path, as_gray=as_gray),
                                      jax_io.imread(jax_path, as_gray=as_gray))
        np.testing.assert_array_equal(image_io.imread(jax_path, as_gray=as_gray),
                                      jax_io.imread(jax_path, as_gray=as_gray))
    assert image_io.decode_png_unfiltered(image_io.encode_png(image)) is not None


@pytest.mark.parametrize("n_colors", [2, 3, 16, 200])
def test_indexed_pngs_decode_in_jax(tmp_path, n_colors):
    rng = np.random.default_rng(n_colors)
    palette = rng.integers(0, 256, (n_colors, 3), dtype=np.uint8)
    labels = rng.integers(0, n_colors, (11, 19)).astype(np.uint8)
    path = str(tmp_path / "labels.png")
    image_io.imsave_indexed(path, labels, palette)
    np.testing.assert_array_equal(jax_io.imread(path), palette[labels])
    np.testing.assert_array_equal(image_io.imread(path), palette[labels])
    got_labels, got_palette = jax_io.imread_labels(path)
    np.testing.assert_array_equal(got_palette[got_labels], palette[labels])


def test_imread_bin_matches_jax(tmp_path):
    page = _page(40, 30, 4)[0]
    path = str(tmp_path / "page.png")
    jax_io.imsave(path, page)
    for binarize in (True, False):
        np.testing.assert_array_equal(image_io.imread_bin(path, binarize), jax_io.imread_bin(path, binarize))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_connected_components_match_jax(connectivity):
    image = np.random.default_rng(connectivity).random((41, 37)) > 0.55
    got = cc.connected_components_with_stats(image, connectivity)
    want = jax_cc.connected_components_with_stats(image, connectivity)
    assert got.num_labels == want.num_labels
    for field in ("labels", "stats", "centroids"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    window = cc.cc_window(got.stats, 3)
    assert window == jax_cc.cc_window(want.stats, 3)


def _prepared_data(seed, high_res=False):
    page, binary = _page(96, 80, seed)
    img, bin_scaled, orig = prepare.prepare_images(page, binary, 6, 16, keep_orig_bin=True)
    fields = dict(image=img, binary=bin_scaled, orig_binary=orig if high_res else None,
                  original_shape=page.shape, image_path="/in/page.png")
    return SingleData(**fields), jax_dataset.SingleData(**fields)


def test_output_masks_match_jax(tmp_path):
    data, jax_data = _prepared_data(6)
    pred = np.random.default_rng(0).integers(0, 3, data.image.shape)
    got = output.generate_output_masks(data, pred, DEFAULT_IMAGE_MAP)
    want = jax_output.generate_output_masks(jax_data, pred, JAX_MAP)
    for field in ("color", "overlay", "inverted_overlay", "fg_color_mask"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    for high_res in (False, True):
        data, jax_data = _prepared_data(6, high_res)
        (gd, gp), (wd, wp) = (output.scale_to_original_shape(data, pred),
                              jax_output.scale_to_original_shape(jax_data, pred))
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_array_equal(gd.binary, wd.binary)
        np.testing.assert_array_equal(gd.image, wd.image)
    # the color/overlay/inverted layout on disk, relative and absolute output_path
    for output_path in ("sub/page.png", str(tmp_path / "abs" / "page.png"), None):
        data.output_path, jax_data.output_path = output_path, output_path
        for out_dir, mod, d, cmap in ((tmp_path / "port", output, data, DEFAULT_IMAGE_MAP),
                                      (tmp_path / "jax", jax_output, jax_data, JAX_MAP)):
            for category in ("color", "overlay", "inverted"):
                os.makedirs(out_dir / category, exist_ok=True)
            mod.output_data(str(out_dir), pred[None], d, cmap)
        rel = output_path if output_path and not os.path.isabs(output_path) else "page.png"
        for category in ("color", "overlay", "inverted"):
            where = (os.path.join(os.path.dirname(output_path), category, "page.png")
                     if output_path and os.path.isabs(output_path) else None)
            got_path = where or str(tmp_path / "port" / category / rel)
            want_path = where or str(tmp_path / "jax" / category / rel)
            np.testing.assert_array_equal(jax_io.imread(got_path), jax_io.imread(want_path))


def test_masks_on_device_match_jax():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 9, 11, 3)).astype(np.float32)
    binary = (rng.random((2, 9, 11)) > 0.5).astype(np.uint8)
    got = output.masks_on_device(torch.from_numpy(logits), torch.from_numpy(binary), torch.from_numpy(PALETTE))
    want = jax_output.masks_on_device(jnp.asarray(logits), jnp.asarray(binary), jnp.asarray(PALETTE))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_postprocessors_match_jax():
    rng = np.random.default_rng(8)
    binary = (rng.random((37, 43)) > 0.5).astype(np.uint8)
    pred = rng.integers(0, 3, binary.shape).astype(np.uint8)
    data, jax_data = SingleData(binary=binary), jax_dataset.SingleData(binary=binary)
    for name in ("cc_majority", "bounding-boxes", "bbox", "votecomponents"):
        got = postprocess.find_postprocessor(name)(pred, data)
        want = jax_post.find_postprocessor(name)(pred, jax_data)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert set(postprocess.POSTPROCESSORS) == set(jax_post.POSTPROCESSORS)
    assert postprocess.postprocess_help() == jax_post.postprocess_help()


@pytest.mark.parametrize("max_iters", [256, 2])
def test_cc_vote_on_device_matches_jax(max_iters):
    """The plain version is the JAX package's loop, so it agrees with it
    exactly even when the loop stops before the fixed point."""
    img, bin_scaled = _prepared(128, 96, 9)
    pred = np.random.default_rng(9).integers(0, 3, img.shape).astype(np.int32)
    got = postprocess.cc_vote_on_device(pred, bin_scaled, 3, max_iters=max_iters, device="cpu")
    want = jax_post.cc_vote_on_device(jnp.asarray(pred), jnp.asarray(bin_scaled), 3, max_iters=max_iters)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if max_iters == 256:  # converged: the host vote
        np.testing.assert_array_equal(got.numpy(), postprocess.vote_connected_component_class(
            pred, SingleData(binary=bin_scaled)))


# -------------------------------------------------------------------- weights
def test_load_checkpoint_of_jax_checkpoint(tmp_path, weights):
    path = str(tmp_path / "ckpt")
    variables = {"params": weights, "batch_stats": {"bn": {"mean": np.arange(4, dtype=np.float32)}}}
    meta = {"architecture": "fcn_skip", "n_classes": 3, "monitor": 0.25, "step": 7}
    save_checkpoint(path, variables, meta)
    got, got_meta = load_checkpoint(path)
    assert got_meta == meta
    assert set(got) == {"params", "batch_stats"} and set(got["params"]) == set(weights)
    for layer, leaves in weights.items():
        for name, want in leaves.items():
            assert got["params"][layer][name].dtype == want.dtype
            assert got["params"][layer][name].tobytes() == want.tobytes()
    np.testing.assert_array_equal(got["batch_stats"]["bn"]["mean"], np.arange(4))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "missing"))


def test_msgpack_restore_matches_flax():
    from flax import serialization

    from page_segmentation_tpu_torch.train.checkpoint import msgpack_restore

    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -32, -33, -128, -129,
                 -32768, -32769, -2**31 - 1, 2**63 - 1, -2**63],
        "floats": [0.5, -1e300, float("inf")],
        "misc": [None, True, False, "", "s" * 40, "ü" * 300, b"\x00\x01", b"b" * 70000],
        "arrays": {str(i): a for i, a in enumerate([
            np.arange(6, dtype=np.int64).reshape(2, 3), np.zeros((0, 4), np.float32),
            np.array([1.5, -2.25], np.float16), np.array([[True, False]]),
            np.arange(300, dtype=np.uint8)])},
        "scalars": [np.float32(2.5), np.int8(-3)],
        "complex": 1 + 2j,
        "wide": {str(i): i for i in range(20)},
        "long": list(range(20)),
    }
    encoded = serialization.msgpack_serialize(tree)
    got, want = msgpack_restore(encoded), serialization.msgpack_restore(encoded)

    def same(g, w):
        if isinstance(w, dict):
            assert set(g) == set(w)
            for k in w:
                same(g[k], w[k])
        elif isinstance(w, (list, tuple)):
            assert len(g) == len(w)
            for a, b in zip(g, w):
                same(a, b)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape and g.tobytes() == w.tobytes()
        else:
            assert type(g) is type(w) and (g == w or (g != g and w != w)), (g, w)

    same(got, want)
    bf16 = serialization.msgpack_serialize({"x": jnp.asarray([1.5, -0.1], jnp.bfloat16)})
    np.testing.assert_array_equal(msgpack_restore(bf16)["x"],
                                  np.asarray(jnp.asarray([1.5, -0.1], jnp.bfloat16), np.float32))


def test_classifier_loads_checkpoint_dir(tmp_path, weights):
    """A JAX checkpoint with meta architecture 'fcn' rebuilds an FCN in both
    packages; float32 predictions agree."""
    tree = init_params_numpy(3, seed=3, skips=False)
    path = str(tmp_path / "fcn")
    save_checkpoint(path, {"params": tree}, {"architecture": "fcn"})
    jax_cls = JaxClassifier(n_classes=3, model_path=path)
    port = PixelClassifier(3, model_path=path, device="cpu")
    assert port.architecture is registry.Architecture.FCN
    data = SingleData(image=_prepared(96, 80, 12)[0])
    got, want = port.predict_single_data(data)[0], jax_cls.predict_single_data(data)[0]
    np.testing.assert_allclose(got, want, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        PixelClassifier(3, model_path=str(tmp_path / "missing"), device="cpu")
    with pytest.raises(FileNotFoundError):
        PixelClassifier(3, model_path=str(tmp_path / "missing.h5"), device="cpu")


def test_architecture_registry_matches_jax():
    assert [a.value for a in registry.Architecture] == [a.value for a in jax_registry.Architecture]
    x = np.random.default_rng(0).uniform(0, 255, (2, 5, 6, 3)).astype(np.float32)
    for arch in registry.Architecture:
        jax_arch = jax_registry.Architecture(arch.value)
        assert arch.preprocess_mode == jax_arch.preprocess_mode
        assert arch.stride_factor == jax_arch.stride_factor
        (fn, rgb), (jax_fn, jax_rgb) = arch.preprocess(), jax_arch.preprocess()
        assert rgb == jax_rgb
        np.testing.assert_allclose(fn(x), jax_fn(x), rtol=1e-6)
        np.testing.assert_allclose(arch.device_preprocess()(torch.from_numpy(x)).numpy(),
                                   np.asarray(jax_arch.device_preprocess()(jnp.asarray(x))), rtol=1e-6)
        with torch.device("meta"):
            assert arch.model(3).n_classes == 3  # every name builds
    with pytest.raises(NotImplementedError, match="item 13"):
        registry.Architecture.FCN_SKIP.model(3, s2d_stem=True)


# ----------------------------------------------------------------- forwards
@pytest.mark.parametrize("shape", [(96, 80), "probe"])
def test_predict_single_data_float32_matches_jax(float32_pair, shape):
    jax_cls, port = float32_pair
    if shape == "probe":  # an odd shape, as the verify drive probes
        image = np.full((37, 53), 128, np.uint8)
    else:
        image = _prepared(*shape, seed=13)[0]
    got, want = port.predict_single_data(SingleData(image=image)), \
        jax_cls.predict_single_data(jax_dataset.SingleData(image=image))
    assert got[0].shape == want[0].shape == image.shape + (3,)
    assert np.abs(got[0] - want[0]).max() <= 1e-4
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert (got[2] == want[2]).mean() >= 0.9999


def _assert_labels_agree(got_pred, want_pred, got_masks, want_masks, bar):
    agree = got_pred == want_pred
    assert agree.mean() >= bar, f"label agreement {agree.mean():.6f}"
    for g, w in zip(got_masks, want_masks):
        np.testing.assert_array_equal(g[agree], w[agree])


def _bucket_batch(n, seed):
    pages = [_prepared(96, 80, seed + i) for i in range(n)]
    return (np.stack([pad.pad_to(img, (40, 32)) for img, _ in pages]),
            np.stack([pad.pad_to(b, (40, 32)) for _, b in pages]))


@pytest.mark.parametrize("device_vote", [False, True])
def test_bf16_predict_batch_masks_matches_jax(bf16_pair, device_vote):
    jax_cls, port = bf16_pair
    images, binaries = _bucket_batch(3, 20)
    got = port.predict_batch_masks(images, binaries, PALETTE, device_vote=device_vote)
    want = jax_cls.predict_batch_masks(images, binaries, PALETTE, device_vote=device_vote)
    assert got[0].dtype == np.uint8 and got[0].shape == want[0].shape
    _assert_labels_agree(got[0], np.asarray(want[0]), got[1], np.asarray(want[1]), 0.999)


def test_device_vote_equals_host_chain(float32_pair):
    """The vote fused into the dispatch == the host cc-vote of the same
    dispatch's unvoted labels (tests/test_device_vote.py's pattern)."""
    port = float32_pair[1]
    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (2, 32, 40)).astype(np.uint8)
    binaries = (rng.rand(2, 32, 40) > 0.5).astype(np.uint8)
    palette = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8)
    plain, _ = port.predict_batch_masks(images, binaries, palette)
    voted, masks = port.predict_batch_masks(images, binaries, palette, device_vote=True)
    for i in range(2):
        want = postprocess.vote_connected_component_class(plain[i].astype(np.int32),
                                                          SingleData(binary=binaries[i]))
        np.testing.assert_array_equal(voted[i], want.astype(np.uint8))
    np.testing.assert_array_equal(masks[0][0], palette[np.minimum(voted[0], 2)])


def _datasets(n_same, seed):
    """n_same pages of one bucket and one of another, as port and JAX entries."""
    shapes = [(96, 80)] * n_same + [(70, 90)]
    port, jax_entries = [], []
    for i, shape in enumerate(shapes):
        img, b = _prepared(*shape, seed=seed + i)
        fields = dict(image=img, binary=b, output_path=f"p{i}.png", original_shape=shape)
        port.append(SingleData(**fields))
        jax_entries.append(jax_dataset.SingleData(**fields))
    return Dataset(port, DEFAULT_IMAGE_MAP), jax_dataset.Dataset(jax_entries, JAX_MAP)


@pytest.mark.parametrize("vote", [False, True])
def test_bf16_predict_dataset_fast_matches_jax(bf16_pair, tmp_path, vote):
    jax_cls, port = bf16_pair
    dataset, jax_dataset_ = _datasets(3, 30)
    post = dict(post_process=[postprocess.vote_connected_component_class], device_post_process=True)
    jax_post_kw = dict(post_process=[jax_post.vote_connected_component_class], device_post_process=True)
    settings = PredictSettings(n_classes=3, output=str(tmp_path / "out"), color_map=DEFAULT_IMAGE_MAP,
                               **(post if vote else {}))
    jax_settings = JaxSettings(n_classes=3, color_map=JAX_MAP, **(jax_post_kw if vote else {}))
    got = list(Predictor(settings, network=port).predict_dataset_fast(dataset, batch_size=2,
                                                                      write_output=True))
    want = list(JaxPredictor(jax_settings, network=jax_cls).predict_dataset_fast(jax_dataset_, batch_size=2))
    assert len(got) == len(want) == 4
    for (gd, gp, *gtrio), (wd, wp, *wtrio) in zip(got, want):
        assert gd.output_path == wd.output_path and gp.shape == wp.shape
        _assert_labels_agree(gp, wp, gtrio, wtrio, 0.999)
        for category, arr in zip(("color", "overlay", "inverted"), gtrio):
            path = str(tmp_path / "out" / category / gd.output_path)
            pixels, palette = image_io.decode_png_unfiltered(open(path, "rb").read())
            np.testing.assert_array_equal(palette[pixels] if palette is not None else pixels, arr)


def test_predictor_single_path_matches_jax(float32_pair, tmp_path):
    jax_cls, port = float32_pair
    dataset, jax_dataset_ = _datasets(1, 40)
    for high_res in (False, True):
        kw = dict(n_classes=3, color_map=DEFAULT_IMAGE_MAP, high_res_output=high_res,
                  output=str(tmp_path / f"port{high_res}"),
                  post_process=[postprocess.vote_connected_component_class])
        jax_kw = dict(kw, color_map=JAX_MAP, output=str(tmp_path / f"jax{high_res}"),
                      post_process=[jax_post.vote_connected_component_class])
        predictor = Predictor(PredictSettings(**kw), network=port)
        jax_predictor = JaxPredictor(JaxSettings(**jax_kw), network=jax_cls)
        for got, want in zip(predictor.predict(dataset), jax_predictor.predict(jax_dataset_)):
            assert got.labels.shape == want.labels.shape
            assert (got.labels == want.labels).mean() >= 0.9999
            np.testing.assert_allclose(got.probabilities, want.probabilities, atol=1e-5)
            predictor.save_prediction(got)
            jax_predictor.save_prediction(want)
            masks, jax_masks = predictor.predict_masks(got.data), jax_predictor.predict_masks(want.data)
            _assert_labels_agree(got.labels, want.labels, [masks.color], [jax_masks.color], 0.9999)
        for category in ("color", "overlay", "inverted"):
            for name in ("p0.png", "p1.png"):
                got_img = jax_io.imread(str(tmp_path / f"port{high_res}" / category / name))
                want_img = jax_io.imread(str(tmp_path / f"jax{high_res}" / category / name))
                assert (got_img == want_img).all(-1).mean() >= 0.9999


def test_unported_options_raise(tmp_path, monkeypatch):
    with pytest.raises(NotImplementedError, match="item 13"):
        PixelClassifier(3, int8=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 13"):
        PixelClassifier(3, s2d_stem=True, device="cpu")
    (tmp_path / "model.meta").write_bytes(b"")  # a TF1 checkpoint, beside no .h5
    monkeypatch.setitem(sys.modules, "tensorflow", None)  # as on the card's machine
    with pytest.raises(ImportError, match="load_tf1_checkpoint"):
        PixelClassifier(3, model_path=str(tmp_path / "model.h5"), device="cpu")
    monkeypatch.undo()
    port = PixelClassifier(3, device="cpu")
    for kw in (dict(n_devices=2), dict(band_rows=256)):
        with pytest.raises(NotImplementedError, match="item 12"):
            Predictor(PredictSettings(n_classes=3, **kw), network=port)
