"""The batched device morphology of the port (segmentation/device_morph.py,
torch on the CPU here) against the JAX package's on the CPU, the port's
native host chain and cv2, for odd and even kernels, mixed char heights in
one batch and ragged batch sizes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.ops import morphology as jax_morphology
from page_segmentation_tpu.segmentation import device_morph as jax_device_morph
from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.segmentation import device_morph
from page_segmentation_tpu_torch.segmentation.pc_segmentation import text_region_mask

CHAR_HEIGHTS = [1, 2, 6, 9, 10, 14, 17, 25]  # odd and even k, k/3, k/1.1


def _masks(seed: int, n: int, shape=(64, 53)) -> np.ndarray:
    rng = np.random.default_rng(seed)
    masks = rng.random((n,) + shape) < 0.08
    line = masks[:, shape[0] // 4 : shape[0] // 4 + 10, 2 : shape[1] - 5]  # a text line
    line |= rng.random(line.shape) < 0.6
    return masks


@pytest.mark.parametrize("char_height", CHAR_HEIGHTS)
def test_chain_equals_jax_and_the_host_chain(char_height):
    masks = _masks(char_height, 3)
    kernels = device_morph.morph_kernels(char_height)
    assert kernels == jax_device_morph.morph_kernels(char_height)
    got = device_morph.text_region_chain(torch.from_numpy(masks), kernels).numpy()
    want = np.asarray(jax_device_morph.text_region_chain(jnp.asarray(masks), kernels))
    assert got.dtype == bool and (got == want).all()
    for page, mask in zip(got, masks):
        assert (page == (native.bitmorph_chain(mask, *kernels) != 0)).all()
        assert (page == (text_region_mask(mask.view(np.uint8), char_height) != 0)).all()


@pytest.mark.parametrize("k", [(1, 1), (2, 3), (3, 2), (4, 4), (5, 8), (7, 7)])
def test_boxes_equal_cv2_at_the_borders(k):
    masks = _masks(sum(k), 2, (21, 19))
    masks[:, 0, :] = masks[:, :, -1] = True  # foreground on the borders
    got_d = device_morph.dilate_box(torch.from_numpy(masks), *k).numpy()
    got_e = device_morph.erode_box(torch.from_numpy(masks), *k).numpy()
    for i, mask in enumerate(masks.astype(np.uint8) * 255):
        assert (got_d[i] == (jax_morphology.dilate(mask, k) != 0)).all()
        assert (got_e[i] == (jax_morphology.erode(mask, k) != 0)).all()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("width", [61, 64])
def test_ragged_batches_and_mixed_char_heights(n, width):
    """Each page's result is the host chain's.  At a width that is a
    multiple of 8 it is also the JAX package's; at another width the JAX
    module reads its row padding as page pixels in the erosions, and the
    port keeps the host chain's (cv2's) border instead."""
    masks = _masks(40 + n, n, (48, width))
    masks[:, :12, -6:] = True  # foreground at the right edge
    heights = [(9, 14, 22)[i % 3] for i in range(n)]
    runner = device_morph.TextRegionMorphDevice(device="cpu")
    got = runner.run(masks, [device_morph.morph_kernels(h) for h in heights])
    assert got.shape == (n, 48, width) and got.dtype == np.uint8
    for page, mask, h in zip(got, masks, heights):
        assert (page == native.bitmorph_chain(mask, *device_morph.morph_kernels(h))).all()
    if width % 8 == 0:
        want = jax_device_morph.TextRegionMorphDevice().run(
            masks, [jax_device_morph.morph_kernels(h) for h in heights])
        assert (got == want).all()
    one = runner.run(masks, device_morph.morph_kernels(14))  # one triple for the batch
    for page, mask in zip(one, masks):
        assert (page == native.bitmorph_chain(mask, *device_morph.morph_kernels(14))).all()


def test_dispatch_and_collect_overlap_batches():
    runner = device_morph.TextRegionMorphDevice(device="cpu")
    masks = _masks(5, 4)
    handles = [runner.dispatch(masks[:2], (9, 3, 8)), runner.dispatch(masks[2:], (14, 4, 12))]
    got = np.concatenate([runner.collect(h) for h in handles])
    want = np.stack([native.bitmorph_chain(m, *k)
                     for m, k in zip(masks, [(9, 3, 8)] * 2 + [(14, 4, 12)] * 2)])
    assert (got == want).all()


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        device_morph.TextRegionMorphDevice()
