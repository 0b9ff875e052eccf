"""The port's CC labeler and vote (page_segmentation_tpu_torch.ops.cuda_cc)
against the JAX package's Pallas kernels in interpret mode and its XLA
twins: labels and voted class maps must be exactly equal.

On the CPU the port runs its plain PyTorch labeler; the CUDA kernel is
held against that plain version in tests/test_torch_cuda.py (and in
chip_smoke.py), which skips without a card."""
import numpy as np
import pytest
import torch

from page_segmentation_tpu.ops import pallas_cc as jax_cc
from page_segmentation_tpu_torch.ops import cuda_cc


def _snake(h, w):
    ink = np.zeros((h, w), np.uint8)
    for row in range(0, h, 2):
        ink[row, :] = 1
        if (row // 2) % 2 == 0 and row + 1 < h:
            ink[row + 1, -1] = 1
        elif row + 1 < h:
            ink[row + 1, 0] = 1
    return ink


def _spiral(n):
    spiral = np.zeros((n, n), np.uint8)
    top, bottom, left, right = 0, n - 1, 0, n - 1
    while top < bottom and left < right:
        spiral[top, left : right + 1] = 1
        spiral[top : bottom + 1, right] = 1
        spiral[bottom, left : right + 1] = 1
        spiral[top : bottom + 1, left] = 1
        top += 4; bottom -= 4; left += 4; right -= 4
    return spiral


def _random_ink(seed, shape, density=0.45):
    return (np.random.default_rng(seed).random(shape) < density).astype(np.uint8)


def _edge_lines(h, w, axis, spine):
    """1-px lines on both sides of every 32-px tile edge of the CUDA labeler,
    vertical (``axis`` 1) or horizontal (0); with ``spine`` the first row or
    column joins them into one comb."""
    ink = np.zeros((h, w), np.uint8)
    at = [i for i in range((h, w)[axis]) if i % 32 in (0, 31)]
    if axis == 1:
        ink[:, at] = 1
        ink[0] = spine
    else:
        ink[at] = 1
        ink[:, 0] = spine
    return ink


def _checkerboard(h, w):
    return (np.add.outer(np.arange(h), np.arange(w)) % 2).astype(np.uint8)


def _ruled(h, w, every=20):
    """Random ink crossed by 1-px rules every ``every`` rows and columns:
    one component through every 32-px tile."""
    ink = _random_ink(9, (h, w), 0.3)
    ink[::every] = 1
    ink[:, ::every] = 1
    return ink


PAGE_CASES = {
    "seed0": lambda: _random_ink(0, (24, 32)),
    "seed1": lambda: _random_ink(1, (24, 32)),
    "snake": lambda: _snake(16, 16),
    "empty": lambda: np.zeros((8, 16), np.uint8),
    "full": lambda: np.ones((8, 16), np.uint8),
    "unaligned": lambda: _random_ink(4, (50, 40), 0.5),
    # the cases the card holds the CUDA tile/border/flatten passes to
    "comb_vertical": lambda: _edge_lines(64, 96, 1, True),
    "lines_vertical_apart": lambda: _edge_lines(64, 96, 1, False),
    "comb_horizontal": lambda: _edge_lines(64, 96, 0, True),
    "lines_horizontal_apart": lambda: _edge_lines(64, 96, 0, False),
    "checkerboard": lambda: _checkerboard(64, 96),
    "ruled": lambda: _ruled(64, 96),
    "ragged_37x53": lambda: _random_ink(10, (37, 53), 0.5),
    "row_1x96": lambda: _random_ink(11, (1, 96), 0.7),
    "column_96x1": lambda: _random_ink(12, (96, 1), 0.7),
    "width_not_16": lambda: _random_ink(13, (40, 44), 0.5),
}


@pytest.mark.parametrize("case", sorted(PAGE_CASES))
def test_whole_page_matches_pallas_kernel(case):
    ink = PAGE_CASES[case]()
    want, _ = jax_cc.cc_min_label_pallas(ink, interpret=True)
    got, _ = cuda_cc.cc_min_label_pallas(ink, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


TILED_CASES = {
    "multiband": lambda: _random_ink(3, (96, 64)),
    "spiral": lambda: _spiral(64),
    "unaligned": lambda: _random_ink(4, (50, 40), 0.5),
    "comb_vertical": lambda: _edge_lines(64, 96, 1, True),
    "comb_horizontal": lambda: _edge_lines(64, 96, 0, True),
    "checkerboard": lambda: _checkerboard(64, 96),
    "ruled": lambda: _ruled(64, 96),
    "ragged_37x53": lambda: _random_ink(10, (37, 53), 0.5),
}


@pytest.mark.parametrize("case", sorted(TILED_CASES))
def test_tiled_matches_pallas_band_kernel(case):
    ink = TILED_CASES[case]()
    want, _ = jax_cc.cc_min_label_tiled(ink, band=16, inner_iters=8, interpret=True)
    got, _ = cuda_cc.cc_min_label_tiled(ink, band=16, inner_iters=8, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batch_matches_xla_batch_per_page_numbering():
    inks = np.stack([_random_ink(5, (20, 28)), _snake(20, 28), np.zeros((20, 28), np.uint8),
                     np.ones((20, 28), np.uint8)])
    want, _ = jax_cc.cc_min_label_xla_batch(inks)
    got, _ = cuda_cc.cc_min_label_batch(inks, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # labels restart on every page: the full page's component is label 1
    assert (got[3] == 1).all()


def test_size_dispatch_matches():
    ink = _random_ink(6, (40, 36))
    want, _ = jax_cc.cc_min_label(ink, interpret=True)
    got, _ = cuda_cc.cc_min_label(ink, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _vote_inputs(seed, n=3, h=24, w=32):
    rng = np.random.default_rng(seed)
    preds = rng.integers(0, 3, (n, h, w)).astype(np.int32)
    inks = (rng.random((n, h, w)) > 0.6).astype(np.uint8)
    inks[-1] = _snake(h, w)  # one long component with a split class vote
    preds[-1, h // 2 :] = 2
    return preds, inks


@pytest.mark.parametrize("seed", [0, 1])
def test_vote_matches_xla_vote(seed):
    preds, inks = _vote_inputs(seed)
    want = np.asarray(jax_cc.cc_vote_batch_xla(preds, inks, n_classes=3))
    got = cuda_cc.cc_vote_batch_xla(torch.from_numpy(preds), inks, 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


def test_vote_matches_pallas_vote():
    preds, inks = _vote_inputs(2)
    want = np.asarray(jax_cc.cc_vote_batch(preds, inks, n_classes=3, interpret=True))
    got = cuda_cc.cc_vote_batch(torch.from_numpy(preds), inks, 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    one = cuda_cc.cc_vote_pallas(preds[0], inks[0], 3, device="cpu")
    np.testing.assert_array_equal(one.numpy(), want[0])


def test_vote_ties_go_to_lowest_class():
    ink = np.zeros((1, 4, 8), np.uint8)
    ink[0, 1, 1:5] = 1  # one component of four pixels
    pred = np.zeros((1, 4, 8), np.int64)
    pred[0, 1, 1:5] = [2, 1, 2, 1]  # 2 votes each for classes 1 and 2
    got = cuda_cc.cc_vote_batch(torch.from_numpy(pred), ink, 3, device="cpu")
    assert (got[0, 1, 1:5] == 1).all()
    assert (got[0][ink[0] == 0] == 0).all()


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.int32, np.float32])
def test_ink_keeps_bool_and_uint8_and_masks_the_rest(dtype):
    """bool and uint8 ink reach the labeler as they are (the kernel takes
    any nonzero byte as ink); other dtypes become ``ink != 0``."""
    ink = (_random_ink(14, (2, 24, 32)) * 200).astype(dtype)
    got = cuda_cc._as_ink(ink, "cpu", 3)
    want_dtype = {np.uint8: torch.uint8, np.bool_: torch.bool}.get(dtype, torch.bool)
    assert got.dtype == want_dtype and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy() != 0, ink != 0)
    labels, _ = cuda_cc.cc_min_label_batch(ink, device="cpu")
    want, _ = jax_cc.cc_min_label_xla_batch((ink != 0).astype(np.uint8))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))


def test_vote_on_uint8_ink_of_any_nonzero_value():
    """A 0/255 binary votes as its 0/1 mask does, in the JAX package too."""
    preds, inks = _vote_inputs(3)
    want = np.asarray(jax_cc.cc_vote_batch_xla(preds, inks, n_classes=3))
    got = cuda_cc.cc_vote_batch(torch.from_numpy(preds), inks * np.uint8(255), 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)

