"""The port's own copy of the host C functions (page_segmentation_tpu_torch
.native) against the JAX package's native library: byte-identical outputs
on the same inputs."""
import numpy as np
import pytest

from page_segmentation_tpu import native as jax_native
from page_segmentation_tpu_torch import native as torch_native

SHAPES = [(3, 17, 24, 24), (2, 33, 40, 48)]  # (n, h, w, padded w)


@pytest.fixture(scope="module", autouse=True)
def _libraries():
    if jax_native.get_lib() is None:
        pytest.fail("the JAX package's native library did not build")
    torch_native.get_lib()


@pytest.mark.parametrize("factor", [2, 3, 8])
def test_decimate_identical(factor):
    rng = np.random.default_rng(factor)
    pages = rng.integers(0, 256, (3, 53, 41), dtype=np.uint8)
    np.testing.assert_array_equal(
        torch_native.decimate_u8(pages, factor), jax_native.decimate_u8(pages, factor)
    )


def test_gather_ink_identical():
    rng = np.random.default_rng(1)
    binaries = rng.integers(0, 256, (2, 60, 45), dtype=np.uint8)
    rows = rng.integers(0, 60, 23)
    cols = rng.integers(0, 45, 17)
    np.testing.assert_array_equal(
        torch_native.gather_ink(binaries, rows, cols),
        jax_native.gather_ink(binaries, rows, cols),
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cc_vote_identical(seed):
    rng = np.random.default_rng(seed)
    binary = (rng.random((31, 45)) > 0.45).astype(np.uint8)
    pred = rng.integers(0, 3, (31, 45)).astype(np.int32)
    np.testing.assert_array_equal(
        torch_native.cc_vote(binary, pred, 3), jax_native.cc_vote(binary, pred, 3)
    )


def _finish_inputs(shape, seed):
    n, h, w, pad_w = shape
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 3, (n, h + 3, pad_w)).astype(np.uint8)
    ink = rng.random((n, h, w)) > 0.55
    quads = pred.reshape(n, h + 3, pad_w // 4, 4).astype(np.uint8)
    packed = (quads[..., 0] | quads[..., 1] << 2 | quads[..., 2] << 4 | quads[..., 3] << 6)
    palette = np.array([[255, 255, 255], [255, 0, 0], [0, 255, 0]], np.uint8)
    return pred, packed.astype(np.uint8), ink, palette


@pytest.mark.parametrize("shape", SHAPES)
def test_finish_masks_identical(shape):
    pred, _, ink, palette = _finish_inputs(shape, 3)
    for got, want in zip(torch_native.finish_masks(pred, ink, palette),
                         jax_native.finish_masks(pred, ink, palette)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_finish_packed_identical(shape):
    _, packed, ink, palette = _finish_inputs(shape, 4)
    for got, want in zip(torch_native.finish_masks_packed(packed, ink, palette),
                         jax_native.finish_masks_packed(packed, ink, palette)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_vote_finish_packed_identical(shape):
    _, packed, ink, palette = _finish_inputs(shape, 5)
    ink_u8 = ink.astype(np.uint8)
    for got, want in zip(torch_native.vote_finish_packed(packed, ink_u8, palette, 3),
                         jax_native.vote_finish_packed(packed, ink_u8, palette, 3)):
        np.testing.assert_array_equal(got, want)


def test_finish_rejects_short_ink():
    pred, _, ink, palette = _finish_inputs(SHAPES[0], 6)
    with pytest.raises(ValueError, match="pages"):
        torch_native.finish_masks(pred, ink[:1], palette)


@pytest.mark.parametrize("bad", [3, -1])
def test_cc_vote_rejects_out_of_range_classes(bad):
    """ps_cc_vote indexes its histogram with the class: the wrapper must
    refuse a class outside [0, n_classes) instead of writing out of bounds."""
    binary = np.ones((4, 6), np.uint8)
    pred = np.zeros((4, 6), np.int32)
    pred[2, 3] = bad
    with pytest.raises(ValueError, match="classes"):
        torch_native.cc_vote(binary, pred, 3)
