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


PAGE_CASES = {
    "seed0": lambda: _random_ink(0, (24, 32)),
    "seed1": lambda: _random_ink(1, (24, 32)),
    "snake": lambda: _snake(16, 16),
    "empty": lambda: np.zeros((8, 16), np.uint8),
    "full": lambda: np.ones((8, 16), np.uint8),
    "unaligned": lambda: _random_ink(4, (50, 40), 0.5),
}


@pytest.mark.parametrize("case", sorted(PAGE_CASES))
def test_whole_page_matches_pallas_kernel(case):
    ink = PAGE_CASES[case]()
    want, _ = jax_cc.cc_min_label_pallas(ink, interpret=True)
    got, _ = cuda_cc.cc_min_label_pallas(ink, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["multiband", "spiral", "unaligned"])
def test_tiled_matches_pallas_band_kernel(case):
    ink = {
        "multiband": lambda: _random_ink(3, (96, 64)),
        "spiral": lambda: _spiral(64),
        "unaligned": lambda: _random_ink(4, (50, 40), 0.5),
    }[case]()
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

