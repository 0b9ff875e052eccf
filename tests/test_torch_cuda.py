"""The CUDA kernels (csrc/cc_label.cu, csrc/add_one.cu, csrc/jax_random.cu)
against their plain PyTorch versions, and the per-page classifier with its device vote, on the
card.  Needs a CUDA card: every test here skips without one
(the kernel has no CPU mode).  The file imports nothing of JAX, so it runs
on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc, prng


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64], ids=str)
@pytest.mark.parametrize("shape", [(8, 512, 54, 38), (3, 5, 7, 11), (1, 1, 1, 1)])
@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_jax_dropout_matches_plain_version(shape, dtype, rate, cuda_device):
    """Forward and backward through the kernel, bit for bit with the plain
    version on the card; one launch each."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda_device, dtype=torch.float64).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device, dtype=torch.float64).to(dtype)
    key = prng.fold_in_static(prng.prng_key(7), ("Dropout_1", 1))
    before = prng.launches
    x.requires_grad_(True)
    y = prng.dropout(x, rate, key)
    (dx,) = torch.autograd.grad(y, x, dy)
    torch.cuda.synchronize()
    assert prng.launches == before + 2
    assert torch.equal(y.detach(), prng.dropout_plain(x.detach(), key, rate))
    assert torch.equal(dx, prng.dropout_plain(dy, key, rate))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 8, 1_000_003])
@pytest.mark.parametrize("minval, maxval", [(-2.5, 2.5), (0.95, 1.05), (0.0, 0.0)])
def test_jax_uniform_matches_plain_version(n, minval, maxval, cuda_device):
    key = prng.split(prng.prng_key(2), 3)[1]
    before = prng.uniform_launches
    got = prng.uniform(key, (n,), minval, maxval, cuda_device)
    torch.cuda.synchronize()
    assert prng.uniform_launches == before + 1
    assert torch.equal(got, prng.uniform_plain(key, (n,), minval, maxval, cuda_device))


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [5, 17, 4099])
def test_int8_layers_on_the_card_equal_the_cpu(cuda_device, rows):
    """The card's integer GEMM (cuBLAS through torch._int_mm, with the
    patch and kernel matrices padded to its shape rules) gives the CPU's
    int32 accumulators, and the float steps around it the same bits."""
    from page_segmentation_tpu_torch.models import quant

    rng = np.random.default_rng(rows)
    for layer in (quant.QConv(3, 5, (5, 5), mode="int8"), quant.QConv(50, 3, (1, 1), mode="int8"),
                  quant.QConvTranspose(70, 20, (2, 2), (2, 2), mode="int8"),
                  quant.QConvTranspose(6, 5, (5, 5), mode="int8")):
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(rng.standard_normal(layer.weight.shape).astype(np.float32)))
            layer.bias.copy_(torch.from_numpy(rng.standard_normal(layer.bias.shape).astype(np.float32)))
            layer.amax.fill_(2.5)
        cin = layer.weight.shape[0 if isinstance(layer, quant.QConvTranspose) else 1]
        x = torch.from_numpy(rng.standard_normal((1, cin, rows, 3)).astype(np.float32))
        with torch.no_grad():
            want_acc, want = layer.accumulate(x), layer(x)
            layer.to(cuda_device)
            got_acc, got = layer.accumulate(x.to(cuda_device)), layer(x.to(cuda_device))
        assert torch.equal(got_acc.cpu(), want_acc) and torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_exported_program_on_the_card(cuda_device, tmp_path):
    from page_segmentation_tpu_torch.inference.aot import AotClassifier, export_classifier
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier

    net = PixelClassifier(3, device=cuda_device, seed=2)
    path = str(tmp_path / "model.zip")
    export_classifier(net, path, platforms=["cuda"])
    images = np.random.default_rng(3).integers(0, 256, (2, 61, 45)).astype(np.uint8)
    padded = np.zeros((2, 64, 48), np.uint8)
    padded[:, :61, :45] = images
    want = net.masks_device(torch.from_numpy(padded).to(cuda_device), None, pack=False).cpu().numpy()
    got = AotClassifier(path, device=cuda_device).predict(images)
    assert (got == want[:, :61, :45]).mean() >= 0.999
    with pytest.raises(ValueError, match="not 'cpu'"):
        AotClassifier(path, device="cpu")


@pytest.mark.cuda
def test_two_shard_mesh_on_one_card_equals_no_mesh(cuda_device):
    """ThroughputPredictor over a mesh of the card twice: each shard labels
    its own pages with the kernel (3 launches a shard), and the trio equals
    the single-device run's."""
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.parallel.mesh import make_mesh

    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(0)
    pages = rng.integers(0, 255, (5, 400, 296)).astype(np.uint8)
    binaries = np.where(pages < 128, 0, 255).astype(np.uint8)
    module = FCNSkip(3).to(cuda_device)

    def run(mesh):
        tp = ThroughputPredictor(module, None, DEFAULT_IMAGE_MAP.palette, (400, 296), 6 / 50,
                                 compute_dtype=torch.float32, download="packed",
                                 cc_vote="pallas", mesh=mesh)
        return list(tp.run(pages, binaries, batch_size=5))[0]

    want = run(None)
    before = cuda_cc.launches
    got = run(make_mesh(devices=[cuda_device, cuda_device]))
    assert cuda_cc.launches - before == 2 * cuda_cc.LAUNCHES_PER_CALL
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_spatial_forward_on_one_card_twice_equals_the_whole_page(cuda_device):
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.parallel.mesh import make_mesh
    from page_segmentation_tpu_torch.parallel.spatial import spatial_forward

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    module = FCNSkip(3).to(cuda_device)
    image = np.random.default_rng(1).random((640, 96, 1)).astype(np.float32)
    split = spatial_forward(module, image, make_mesh(devices=[cuda_device, cuda_device]), margin=80)
    with torch.no_grad():
        whole = module(torch.from_numpy(image[None]).to(cuda_device))[0].cpu().numpy()
    assert np.abs(split - whole).max() <= 5e-4 * np.abs(whole).max()


@pytest.mark.cuda
def test_train_quality_trains_and_evaluates_on_the_card(cuda_device, tmp_path):
    """The golden-corpus workflow (gen-masks, create-dataset-file, train,
    predict --fast --high_res_output, evaluate) with train and predict on
    the card, for 2 epochs; the record has the JAX tool's keys."""
    import json

    from page_segmentation_tpu_torch.tools import train_quality

    record = tmp_path / "quality.json"
    assert train_quality.main(["--n-epoch", "2", "--monitor", "val_accuracy",
                               "--record", str(record)]) == 0
    result = json.loads(record.read_text())
    assert result["split_seed"] == 10 and result["test_pages"] == ["page10", "page4"]
    assert result["epochs_ran"] == 2 and 0.0 <= result["value"] <= 1.0
    assert set(result["per_label"]) == {"label_0", "label_1", "label_2"}
