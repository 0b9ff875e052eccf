"""The port's own copy of the host C functions (page_segmentation_tpu_torch
.native) against the JAX package's native library: byte-identical outputs
on the same inputs."""
import os
import threading

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


A4 = (3508, 2480)
# (pages, h, w), factor.  The port splits a large batch over threads and
# sums factor-8 cells with SAD instructions 32 and 16 bytes wide, then one
# cell at a time; the JAX package's copy is one scalar thread.
DECIMATE_CASES = [
    *[((3, 53, 41), f) for f in (1, 2, 3, 5, 8, 16)],
    # w < 8 * factor, w % factor != 0, w no multiple of 32: SIMD tails
    ((2, 9, 15), 2), ((2, 13, 23), 3), ((2, 21, 39), 5), ((2, 70, 127), 16),
    ((2, 17, 63), 8), ((2, 17, 17), 8), ((2, 19, 9), 8), ((1, 30, 1005), 8),
    # one page past the split size, h / 8 = 433 rows (prime), ragged edges
    ((1, 3469, 2479), 8), ((1, 3469, 2479), 3),
    ((1,) + A4, 8), ((4,) + A4, 8),
]


@pytest.mark.parametrize("shape, factor", DECIMATE_CASES,
                         ids=[f"{'x'.join(map(str, s))}-f{f}" for s, f in DECIMATE_CASES])
def test_decimate_identical(shape, factor):
    rng = np.random.default_rng(factor + sum(shape))
    pages = rng.integers(0, 256, shape, dtype=np.uint8)
    np.testing.assert_array_equal(
        torch_native.decimate_u8(pages, factor), jax_native.decimate_u8(pages, factor)
    )


def test_decimate_threads_follow_the_size():
    """One thread on a tiny input; an A4 page splits when the process sees
    at least 4 CPUs (the split leaves two of them to other threads)."""
    tiny = np.zeros((1, 16, 16), np.uint8)
    assert torch_native.decimate_u8(tiny, 8, with_threads=True)[1] == 1
    if len(os.sched_getaffinity(0)) < 4:
        pytest.skip("the process sees fewer than 4 CPUs")
    page = np.zeros((1,) + A4, np.uint8)
    out, threads = torch_native.decimate_u8(page, 8, with_threads=True)
    assert out.shape == (1, A4[0] // 8, A4[1] // 8)
    assert 1 < threads <= len(os.sched_getaffinity(0)) - 2


def test_decimate_from_four_threads_at_once():
    """The prefetch and serve threads decimate concurrently: every call's
    output equals the one-thread reference's on its own batch."""
    rng = np.random.default_rng(7)
    batches = [rng.integers(0, 256, (2, 1757, 1243), dtype=np.uint8) for _ in range(4)]
    want = [jax_native.decimate_u8(b, 8) for b in batches]
    start = threading.Barrier(len(batches))
    got = [[] for _ in batches]

    def work(i):
        start.wait(timeout=30)
        for _ in range(5):
            got[i].append(torch_native.decimate_u8(batches[i], 8))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(len(batches))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for outs, w in zip(got, want):
        assert len(outs) == 5
        for out in outs:
            np.testing.assert_array_equal(out, w)


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
