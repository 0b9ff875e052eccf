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


def _edge_lines(h, w, axis, spine=True):
    """1-px lines on both sides of every 32-px tile edge along ``axis``
    (1: vertical lines, 0: horizontal), joined by a spine on the first
    row or column when ``spine``."""
    ink = np.zeros((h, w), bool)
    at = [i for i in range((h, w)[axis]) if i % 32 in (0, 31)]
    if axis == 1:
        ink[:, at] = True
        ink[0] = spine
    else:
        ink[at] = True
        ink[:, 0] = spine
    return ink


def _checkerboard(h, w):
    return (np.add.outer(np.arange(h), np.arange(w)) % 2).astype(bool)


def _rules(h, w, every=20):
    """1-px rules every ``every`` rows and columns over random ink: one
    component that crosses every 32-px tile."""
    ink = _random(6, (h, w), 0.3)
    ink[::every] = True
    ink[:, ::every] = True
    return ink


CASES = {
    "random_sparse": lambda: _random(0, (3, 24, 32), 0.45),
    "random_dense": lambda: _random(1, (2, 50, 40), 0.6),
    "snake": lambda: _snake(64, 48)[None],
    "empty_full": lambda: np.stack([np.zeros((8, 16), bool), np.ones((8, 16), bool)]),
    "page_batch": lambda: _random(2, (48, 424, 304), 0.45),
    "comb_vertical": lambda: np.stack([_edge_lines(424, 304, 1), _edge_lines(424, 304, 1, False)]),
    "lines_horizontal": lambda: np.stack([_edge_lines(424, 304, 0), _edge_lines(424, 304, 0, False)]),
    "checkerboard": lambda: _checkerboard(424, 304)[None],
    "rules_page": lambda: _rules(424, 304)[None],
    "ragged_421x298": lambda: _random(7, (2, 421, 298), 0.5),
    "row_1x4096": lambda: _random(8, (2, 1, 4096), 0.7),
    "column_4096x1": lambda: _random(9, (2, 4096, 1), 0.7),
    "width_not_16": lambda: _random(10, (3, 424, 300), 0.5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_plain_version(case, cuda_device):
    ink = torch.from_numpy(CASES[case]()).to(cuda_device)
    before = cuda_cc.launches
    got, _ = cuda_cc.cc_min_label_batch(ink, device=cuda_device)
    torch.cuda.synchronize()
    assert cuda_cc.launches == before + cuda_cc.LAUNCHES_PER_CALL
    want, _ = cuda_cc.cc_min_label_reference(ink)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bool, torch.uint8])
def test_kernel_takes_bool_and_uint8_as_they_are(dtype, cuda_device):
    ink = torch.from_numpy(_random(11, (2, 70, 96), 0.5)).to(cuda_device).to(dtype)
    if dtype == torch.uint8:
        ink = ink * 200  # any nonzero byte is ink
    got = cuda_cc._label_cuda(ink)
    assert torch.equal(got, cuda_cc.cc_min_label_reference(ink)[0])
    with pytest.raises(ValueError, match="contiguous"):
        cuda_cc._label_cuda(ink.transpose(1, 2))


@pytest.mark.cuda
def test_tiled_entry_launches_the_kernel(cuda_device):
    ink = torch.from_numpy(_random(3, (600, 500), 0.5)).to(cuda_device)  # > 240,000 px
    before = cuda_cc.launches
    got, _ = cuda_cc.cc_min_label(ink, device=cuda_device)
    assert cuda_cc.launches == before + cuda_cc.LAUNCHES_PER_CALL
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
@pytest.mark.parametrize("layout", ["transposed", "int64", "offset_view", "ragged_7"])
def test_add_one_on_other_layouts(layout, cuda_device):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-2**20, 2**20, (424, 304))).to(cuda_device)
    x = {"transposed": lambda: x.to(torch.int32).t(),
         "int64": lambda: x,
         "offset_view": lambda: x.to(torch.int32).flatten()[1:],  # int32, not 16-byte aligned
         "ragged_7": lambda: x.to(torch.int32).flatten()[:7]}[layout]()
    got = cuda_add_one.add_one(x, device=cuda_device)
    assert got.dtype == torch.int32 and got.is_contiguous()
    assert torch.equal(got, cuda_add_one.add_one_reference(x))


@pytest.mark.cuda
def test_launch_lands_on_the_callers_stream(cuda_device):
    from page_segmentation_tpu_torch._kernels import current_raw_stream

    index = torch.cuda.current_device()
    assert current_raw_stream(index) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert current_raw_stream(index) == torch.cuda.current_stream().cuda_stream
        assert current_raw_stream(index) == side.cuda_stream
        x = torch.zeros((424, 304), dtype=torch.int32, device=cuda_device)
        torch.cuda._sleep(50_000_000)  # keep the side stream busy for tens of ms
        x.fill_(41)
        got = cuda_add_one.add_one(x, device=cuda_device)
        ink = torch.zeros((1, 64, 64), dtype=torch.bool, device=cuda_device)
        torch.cuda._sleep(50_000_000)
        ink.fill_(True)
        labels = cuda_cc._label_cuda(ink)
    side.synchronize()
    assert (got == 42).all()
    assert (labels == 1).all()


@pytest.mark.cuda
def test_launch_off_the_current_card(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: the device guard runs only off the current card")
    other = torch.device("cuda", 1 if torch.cuda.current_device() == 0 else 0)
    x = torch.arange(1000, dtype=torch.int32, device=other)
    got = cuda_add_one.add_one(x, device=other)
    assert got.device == other and torch.equal(got, x + 1)
    ink = torch.from_numpy(_random(12, (2, 64, 96), 0.5)).to(other)
    labels = cuda_cc._label_cuda(ink)
    assert labels.device == other
    assert torch.equal(labels, cuda_cc.cc_min_label_reference(ink)[0])


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
    assert cuda_cc.launches == before + cuda_cc.LAUNCHES_PER_CALL
    want_pred, want_masks = cpu.predict_batch_masks(images, binaries, palette, device_vote=True)
    assert (got_pred == want_pred).mean() >= 0.9999
    pred = rng.randint(0, 3, (48, 40)).astype(np.int32)
    want = cc_vote_on_device(pred, binaries[0], 3, device="cpu")
    assert torch.equal(cc_vote_on_device(pred, binaries[0], 3, device=cuda_device).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [248, 251])
def test_device_morphology_on_the_card_equals_the_host_chain(cuda_device, width):
    from page_segmentation_tpu_torch import native
    from page_segmentation_tpu_torch.segmentation.device_morph import (
        TextRegionMorphDevice,
        morph_kernels,
    )

    rng = np.random.default_rng(width)
    masks = rng.random((5, 300, width)) < 0.05
    masks[:, 40:60, 10:] |= rng.random((5, 20, width - 10)) < 0.6
    heights = [9, 14, 50, 14, 10]
    kernels = [morph_kernels(h) for h in heights]
    got = TextRegionMorphDevice(cuda_device).run(masks, kernels)
    for page, mask, k in zip(got, masks, kernels):
        assert (page == native.bitmorph_chain(mask, *k)).all()


@pytest.mark.cuda
def test_torch_dilate_erode_on_the_card_equal_the_cpu(cuda_device):
    from page_segmentation_tpu_torch.ops.morphology import dilate_torch, erode_torch

    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (61, 47, 3), dtype=np.uint8))
    for k in ((3, 3), (4, 6), (9, 2)):
        for fn in (dilate_torch, erode_torch):
            assert torch.equal(fn(x.to(cuda_device), k).cpu(), fn(x, k))
