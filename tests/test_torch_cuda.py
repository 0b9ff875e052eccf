"""The CUDA kernels (csrc/cc_label.cu, csrc/add_one.cu) against their plain
PyTorch versions, and the per-page classifier with its device vote, on the
card.  Needs a CUDA card: every test here skips without one
(the kernel has no CPU mode).  The file imports nothing of JAX, so it runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _random(seed, shape, density):
    return np.random.default_rng(seed).random(shape) < density


def _snake(h, w):
    ink = np.zeros((h, w), bool)
    ink[::2] = True
    for row in range(1, h, 2):
        ink[row, -1 if (row // 2) % 2 == 0 else 0] = True
    return ink


CASES = {
    "random_sparse": lambda: _random(0, (3, 24, 32), 0.45),
    "random_dense": lambda: _random(1, (2, 50, 40), 0.6),
    "snake": lambda: _snake(64, 48)[None],
    "empty_full": lambda: np.stack([np.zeros((8, 16), bool), np.ones((8, 16), bool)]),
    "page_batch": lambda: _random(2, (48, 424, 304), 0.45),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, cuda_device):
    ink = torch.from_numpy(CASES[case]()).to(cuda_device)
    before = cuda_cc.launches
    got, _ = cuda_cc.cc_min_label_batch(ink, device=cuda_device)
    torch.cuda.synchronize()
    assert cuda_cc.launches == before + 3
    want, _ = cuda_cc.cc_min_label_reference(ink)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_tiled_entry_launches_the_kernel(cuda_device):
    ink = torch.from_numpy(_random(3, (600, 500), 0.5)).to(cuda_device)  # > 240,000 px
    before = cuda_cc.launches
    got, _ = cuda_cc.cc_min_label(ink, device=cuda_device)
    assert cuda_cc.launches == before + 3
    assert torch.equal(got, cuda_cc.cc_min_label_reference(ink[None])[0][0])


@pytest.mark.cuda
def test_vote_on_the_card_matches_cpu(cuda_device):
    rng = np.random.default_rng(4)
    pred = torch.from_numpy(rng.integers(0, 3, (4, 40, 48)))
    ink = torch.from_numpy(rng.random((4, 40, 48)) > 0.55)
    want = cuda_cc.cc_vote_batch(pred, ink, 3, device="cpu")
    got = cuda_cc.cc_vote_batch(pred.to(cuda_device), ink.to(cuda_device), 3, device=cuda_device)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(424, 304), (3, 1000, 777), (1,)])
def test_add_one_matches_plain_version(shape, cuda_device):
    x = torch.from_numpy(np.random.default_rng(5).integers(-2**31, 2**31 - 1, shape, dtype=np.int64))
    x = x.to(torch.int32).to(cuda_device)
    before = cuda_add_one.launches
    got = cuda_add_one.add_one(x, device=cuda_device)
    torch.cuda.synchronize()
    assert cuda_add_one.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, cuda_add_one.add_one_reference(x))


@pytest.mark.cuda
def test_classifier_device_vote_on_the_card_matches_cpu(cuda_device, monkeypatch):
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.postprocess import cc_vote_on_device

    rng = np.random.RandomState(2)
    images = rng.randint(0, 256, (2, 48, 40)).astype(np.uint8)
    binaries = (rng.rand(2, 48, 40) > 0.5).astype(np.uint8)
    palette = np.array([[0, 0, 0], [255, 0, 0], [0, 255, 0]], np.uint8)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)  # float32 is float32
    card, cpu = PixelClassifier(3, device=cuda_device), PixelClassifier(3, device="cpu")
    before = cuda_cc.launches
    got_pred, got_masks = card.predict_batch_masks(images, binaries, palette, device_vote=True)
    assert cuda_cc.launches == before + 3
    want_pred, want_masks = cpu.predict_batch_masks(images, binaries, palette, device_vote=True)
    assert (got_pred == want_pred).mean() >= 0.9999
    pred = rng.randint(0, 3, (48, 40)).astype(np.int32)
    want = cc_vote_on_device(pred, binaries[0], 3, device="cpu")
    assert torch.equal(cc_vote_on_device(pred, binaries[0], 3, device=cuda_device).cpu(), want)
