"""The port's raw-corpus streamer (``inference/corpus.py``) and its 1-bit PNG
and binarization helpers, against the port's own ThroughputPredictor and the
JAX package's corpus streamer, on the CPU.

Tolerances: the streamer equals a direct ThroughputPredictor run exactly;
packed bilevel binaries, binary-free threshold and Otsu modes equal the
runs on precomputed 8-bit binaries exactly; the bilevel PNG bytes and the
binarization equal the JAX package's exactly.  Against the JAX streamer in
float32 the labels (decoded from the color masks) agree on >= 99.99 % of
pixels, the convolutions being summed in another order, and each trio is
exactly the trio of its own labels."""
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core import image_io as jax_io
from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
from page_segmentation_tpu.inference.corpus import RawCorpusPredictor as JaxCorpus
from page_segmentation_tpu.inference.corpus import RawPage as JaxPage
from page_segmentation_tpu.inference.corpus import pick_host_decimate as jax_pick
from page_segmentation_tpu.ops import threshold as jax_threshold
from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu_torch.core.image_io import (
    imread,
    imread_bilevel_packed,
    imsave,
    imsave_bilevel,
)
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.inference.corpus import (
    RawCorpusPredictor,
    RawPage,
    pick_host_decimate,
)
from page_segmentation_tpu_torch.inference.output import finish_mask_trio
from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor, nearest_index_array
from page_segmentation_tpu_torch.models.bridge import init_params_numpy
from page_segmentation_tpu_torch.ops.threshold import binarize_into, otsu_threshold
from page_segmentation_tpu_torch.train.checkpoint import save_checkpoint

PALETTE = DEFAULT_IMAGE_MAP.palette
CORPUS = Path(__file__).resolve().parent / "golden_corpus"


def _page(h, w, seed):
    rng = np.random.RandomState(seed)
    img = np.full((h, w), 235, np.uint8)
    for row in range(h // 8, h - 16, 24):
        for col in range(w // 10, w - 12, 14):
            if rng.rand() < 0.8:
                img[row : row + 12, col : col + 8] = rng.randint(10, 60)
    return img


def _write_corpus(root, shapes, line_height=24):
    """shapes: [(h, w, count)] -> RawPages with 8-bit threshold-128 binaries."""
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "binary"), exist_ok=True)
    pages, i = [], 0
    for h, w, count in shapes:
        for _ in range(count):
            img = _page(h, w, i)
            name = f"p{i:03d}.png"
            imsave(os.path.join(root, "images", name), img)
            imsave(os.path.join(root, "binary", name), ((img >= 128) * 255).astype(np.uint8))
            pages.append(RawPage(os.path.join(root, "images", name),
                                 os.path.join(root, "binary", name), line_height))
            i += 1
    return pages


@pytest.fixture(scope="module")
def weights():
    tree = init_params_numpy(3, seed=0)
    rng = np.random.default_rng(1)
    for leaves in tree.values():  # nonzero biases exercise the bias path
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def classifier(weights):
    cls = PixelClassifier(3, compute_dtype=torch.float32, device="cpu")
    cls.params = weights
    return cls


def _runner(cls, **kwargs):
    return RawCorpusPredictor(cls, PALETTE, compute_dtype=torch.float32, **kwargs)


def _trios(runner, pages):
    return {p.name: [np.copy(m) for m in trio] for p, *trio in runner.run(pages)}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for name in want:
        for g, w in zip(got[name], want[name]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("scale", [6 / 50, 0.5, 1.0, 2.0, 0.01, 6 / 14])
def test_pick_host_decimate_matches_jax(scale):
    assert pick_host_decimate(scale) == jax_pick(scale)
    assert pick_host_decimate(6 / 50) == 8 and pick_host_decimate(0.01) == 8


def test_pick_host_decimate_rejects_a_non_positive_scale():
    with pytest.raises(ValueError):
        pick_host_decimate(0.0)


def test_groups_by_shape_and_line_height(tmp_path, classifier):
    pages = _write_corpus(str(tmp_path), [(96, 80, 3), (120, 88, 2)])
    pages[-1].line_height_px = 32  # same shape, another norm: its own group
    groups = _runner(classifier).group(pages)
    assert sorted(k for k, _ in groups) == [(96, 80, 24), (120, 88, 24), (120, 88, 32)]
    assert sum(len(m) for _, m in groups) == 5


@pytest.mark.parametrize("cc_vote", [False, True, "pallas"])
def test_matches_direct_throughput_predictor(tmp_path, classifier, cc_vote):
    h, w, lh = 96, 80, 24
    pages = _write_corpus(str(tmp_path), [(h, w, 4)], line_height=lh)
    got = _trios(_runner(classifier, batch_size=2, cc_vote=cc_vote), pages)
    scale = 6 / lh
    direct = ThroughputPredictor(
        classifier.module, None, PALETTE, (h, w), scale, host_decimate=pick_host_decimate(scale),
        compute_dtype=torch.float32, download="packed", cc_vote=cc_vote, device="cpu")
    images = np.stack([imread(p.image_path, as_gray=True) for p in pages])
    binaries = np.stack([imread(p.binary_path, as_gray=True) for p in pages])
    ref = [m for batch in direct.run(images, binaries, batch_size=2) for m in zip(*batch)]
    for page, trio in zip(pages, ref):
        for g, want in zip(got[page.name], trio):
            np.testing.assert_array_equal(g, want)


def test_window_bounds_and_order_and_written_trio(tmp_path, classifier):
    pages = _write_corpus(str(tmp_path), [(96, 80, 5)])
    out = tmp_path / "out"
    seen = [(p.name, trio) for p, *trio in _runner(classifier, batch_size=2, window=2).run(
        pages, output_dir=str(out))]
    assert [name for name, _ in seen] == [p.name for p in pages]
    for name, trio in seen:
        for sub, arr in zip(("color", "overlay", "inverted"), trio):
            np.testing.assert_array_equal(imread(out / sub / name), arr)


def test_unported_and_invalid_options_raise(classifier):
    assert _runner(classifier, int8=True).int8  # ported: tests/test_torch_quant.py
    with pytest.raises(ValueError, match="binarize"):
        _runner(classifier, binarize="sauvola")


def test_bilevel_png_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((37, 53), (8, 16), (1, 1)):
        binary = np.where(rng.random(shape) < 0.3, 0, 255).astype(np.uint8)
        imsave_bilevel(tmp_path / "port.png", binary)
        jax_io.imsave_bilevel(tmp_path / "jax.png", binary)
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
        rows, w = imread_bilevel_packed(tmp_path / "port.png")
        want_rows, want_w = jax_io.imread_bilevel_packed(tmp_path / "jax.png")
        assert w == want_w == shape[1]
        np.testing.assert_array_equal(rows, want_rows)
        np.testing.assert_array_equal(imread(tmp_path / "port.png", as_gray=True), binary)
    imsave(tmp_path / "gray.png", binary)
    assert imread_bilevel_packed(tmp_path / "gray.png") is None
    assert imread_bilevel_packed(tmp_path / "missing.png") is None
    (tmp_path / "cut.png").write_bytes((tmp_path / "port.png").read_bytes()[:30])
    assert imread_bilevel_packed(tmp_path / "cut.png") is None


@pytest.mark.parametrize("threshold", [128, 1, 255])
def test_binarize_into_matches_jax(threshold):
    gray = np.random.default_rng(threshold).integers(0, 256, (33, 47)).astype(np.uint8)
    got, want = np.empty_like(gray), np.empty_like(gray)
    binarize_into(gray, got, threshold)
    jax_threshold.binarize_into(gray, want, threshold)
    np.testing.assert_array_equal(got, want)
    strided = np.empty((33, 94), np.uint8)[:, ::2]  # not contiguous
    np.testing.assert_array_equal(binarize_into(gray, strided, threshold), want)
    with pytest.raises(ValueError, match="uint8"):
        binarize_into(gray, np.empty((33, 47), np.int16))


def test_packed_bilevel_binaries_equal_expanded(tmp_path, classifier):
    pages = _write_corpus(str(tmp_path), [(96, 80, 3)])
    os.makedirs(tmp_path / "binary1")
    packed_pages = []
    for p in pages:
        path = str(tmp_path / "binary1" / os.path.basename(p.binary_path))
        imsave_bilevel(path, imread(p.binary_path, as_gray=True))
        packed_pages.append(RawPage(p.image_path, path, p.line_height_px))
    runner = _runner(classifier, batch_size=2, cc_vote="pallas")
    assert runner._predictor_for((96, 80, 24), packed_binary=True).packed_binary
    _assert_same(_trios(runner, packed_pages), _trios(runner, pages))


def test_binary_free_modes_equal_precomputed_binary_files(tmp_path, classifier):
    pages = _write_corpus(str(tmp_path), [(96, 80, 3)])
    free = [RawPage(p.image_path, None, p.line_height_px) for p in pages]
    _assert_same(_trios(_runner(classifier, batch_size=2), free),
                 _trios(_runner(classifier, batch_size=2), pages))

    os.makedirs(tmp_path / "otsu")
    with_files = []
    for p in pages:
        img = imread(p.image_path, as_gray=True)
        path = str(tmp_path / "otsu" / p.name)
        imsave(path, ((img > otsu_threshold(img)) * 255).astype(np.uint8))
        with_files.append(RawPage(p.image_path, path, p.line_height_px))
    _assert_same(_trios(_runner(classifier, batch_size=2, binarize="otsu"), free),
                 _trios(_runner(classifier, batch_size=2), with_files))


def test_heterogeneous_shapes_and_ring_reuse(tmp_path, classifier):
    pages = _write_corpus(str(tmp_path), [(96, 80, 3), (120, 88, 1)])
    more = _write_corpus(str(tmp_path / "b"), [(120, 88, 4)], line_height=32)
    for j, p in enumerate(more):
        p.output_name = f"b{j:03d}.png"
    pages = pages + more
    runner = _runner(classifier, batch_size=2, window=2)
    assert runner._spare_ring is None
    got = _trios(runner, pages)
    ring = runner._spare_ring
    assert len(got) == 8 and ring is not None
    for group in (pages[:3], pages[3:4], pages[4:]):  # each group alone, fresh ring
        for p, *trio in _runner(classifier, batch_size=2, window=2).run(group):
            for g, w in zip(got[p.name], trio):
                np.testing.assert_array_equal(g, w)
    # overlapping runs hold distinct rings; a closed run parks its ring back
    first, second = runner.run(pages), runner.run(pages)
    next(first)
    next(second)
    first.close()
    assert runner._spare_ring is ring
    assert len(list(second)) == len(pages) - 1
    _assert_same(_trios(runner, pages), got)
    assert runner._spare_ring is ring


def test_port_matches_jax_streamer_on_the_golden_corpus(weights, tmp_path):
    names = sorted(os.listdir(CORPUS / "images"))
    assert len(names) == 11
    ports = [RawPage(str(CORPUS / "images" / n), str(CORPUS / "binary" / n), 14) for n in names]
    jaxes = [JaxPage(p.image_path, p.binary_path, 14) for p in ports]
    # both classifiers load one checkpoint, written by the port
    save_checkpoint(str(tmp_path / "model"), {"params": weights}, {"architecture": "fcn_skip"})
    port_cls = PixelClassifier(3, compute_dtype=torch.float32, model_path=str(tmp_path / "model"),
                               device="cpu")
    jax_cls = JaxClassifier(n_classes=3, compute_dtype=jnp.float32, model_path=str(tmp_path / "model"))
    got = _trios(RawCorpusPredictor(port_cls, PALETTE, batch_size=4, compute_dtype=torch.float32), ports)
    want = _trios(JaxCorpus(jax_cls, PALETTE, batch_size=4, compute_dtype=jnp.float32), jaxes)
    assert got.keys() == want.keys()

    def labels(color):
        return (color[..., None, :] == PALETTE).all(-1).argmax(-1).astype(np.uint8)

    agree = total = 0
    for page in ports:
        (color, overlay, inverted), jax_trio = got[page.name], want[page.name]
        binary = imread(page.binary_path, as_gray=True)
        h, w = color.shape[:2]
        ink = native.gather_ink(binary[None], nearest_index_array(h, binary.shape[0]),
                                nearest_index_array(w, binary.shape[1]))
        for trio in ((color, overlay, inverted), jax_trio):
            for g, want_arr in zip(trio, finish_mask_trio(labels(trio[0])[None], ink, PALETTE)):
                np.testing.assert_array_equal(g, want_arr[0])
        same = labels(color) == labels(jax_trio[0])
        agree, total = agree + int(same.sum()), total + same.size
    assert agree / total >= 0.9999, f"label agreement {agree / total:.6f}"
