"""The port's fused predict program and ThroughputPredictor against the JAX
package's, on the same pages and the same weights (float32 on both sides).

Tolerances: the normalized input agrees to 0.01 gray levels (two cubic
resamplers); class maps agree on >= 99.99 % of pixels (convolutions summed
in another order can flip a near-tie argmax), and every product of the
labels (colors, packed bytes, the trio) is byte-equal wherever the labels
agree.  Votes computed from the same labels are exactly equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu.inference import output as jax_output
from page_segmentation_tpu.inference import pipeline as jax_pipeline
from page_segmentation_tpu.models.fcn import FCNSkip as JaxFCNSkip
from page_segmentation_tpu.ops.pallas_cc import cc_vote_batch_xla
from page_segmentation_tpu_torch.inference import output as torch_output
from page_segmentation_tpu_torch.inference import pipeline as torch_pipeline
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.ops.cuda_cc import cc_vote_batch

PAGE = (400, 296)
SCALE = 6 / 50
NORMALIZED = (int(np.round(PAGE[0] * SCALE)), int(np.round(PAGE[1] * SCALE)))
PALETTE = DEFAULT_IMAGE_MAP.palette


@pytest.fixture(scope="module")
def weights():
    tree = init_params_numpy(3, seed=0)
    rng = np.random.default_rng(1)
    for leaves in tree.values():
        leaves["bias"] = (0.05 * rng.standard_normal(leaves["bias"].shape)).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def pages():
    rng = np.random.default_rng(4)
    pages = rng.integers(0, 255, (2,) + PAGE).astype(np.uint8)
    return pages, np.where(pages < 128, 0, 255).astype(np.uint8)


def _torch_module(weights):
    module = FCNSkip(3)
    module.load_state_dict(params_from_jax(weights))
    return module


@pytest.fixture(scope="module")
def prepared(weights, pages):
    """Decimated pages and the padded, 1-bit-packed ink, from the JAX
    package's own host prep."""
    jax_tp = jax_pipeline.ThroughputPredictor(
        JaxFCNSkip(n_classes=3), weights, PALETTE, PAGE, SCALE,
        compute_dtype=jnp.float32, download="pred", cc_vote="xla")
    dec_dev, ink = jax_tp._prep(*pages)
    return np.array(dec_dev), ink, jax_tp._pack_ink(ink)


def _classes(out, download):
    """Class map of a fused output (colors decoded through the palette)."""
    out = np.asarray(out)
    if download == "packed":
        return jax_output.unpack_classes(out)
    if download == "pred":
        return out
    return (out[..., None, :] == PALETTE).all(-1).argmax(-1)


def _assert_agree(got, want, download):
    agree = _classes(got, download) == _classes(want, download)
    assert agree.mean() >= 0.9999, f"label agreement {agree.mean():.6f}"
    if download == "packed":  # a byte holds 4 pixels: compare bytes whose pixels all agree
        agree = agree.reshape(got.shape + (4,)).all(-1)
    np.testing.assert_array_equal(got[agree], want[agree])


def test_normalize_matches_jax(prepared):
    dec = prepared[0]
    pad_h, pad_w = 48, 40
    want = np.asarray(jax_pipeline._device_normalize(*NORMALIZED, pad_h, pad_w)(jnp.asarray(dec)))
    got = torch_pipeline._device_normalize(*NORMALIZED, pad_h, pad_w)(torch.from_numpy(dec))
    assert got.shape == (2, 1, pad_h, pad_w)
    assert np.abs(got[:, 0].numpy() - want[..., 0]).max() * 255 <= 0.01


@pytest.mark.parametrize("cc_vote", [False, "pallas"])
@pytest.mark.parametrize("download", ["color", "pred", "packed"])
def test_fused_predict_matches_jax(weights, prepared, download, cc_vote):
    dec, _, ink_packed = prepared
    jax_fused = jax_pipeline.make_fused_predict(
        JaxFCNSkip(n_classes=3), NORMALIZED, compute_dtype=jnp.float32,
        download=download, cc_vote=cc_vote)
    torch_fused = torch_pipeline.make_fused_predict(
        _torch_module(weights), NORMALIZED, compute_dtype=torch.float32,
        download=download, cc_vote=cc_vote, device="cpu")
    assert torch_fused.padded_shape == jax_fused.padded_shape
    args = (jnp.asarray(dec), jnp.asarray(PALETTE)) + ((jnp.asarray(ink_packed),) if cc_vote else ())
    want = np.asarray(jax_fused({"params": weights}, *args))
    targs = (torch.from_numpy(dec), torch.from_numpy(PALETTE)) + (
        (torch.from_numpy(ink_packed),) if cc_vote else ())
    got = torch_fused(*targs).numpy()
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    _assert_agree(got, want, download)


def test_device_vote_on_own_labels_equals_jax_xla_vote(weights, prepared):
    dec, _, ink_packed = prepared
    module = _torch_module(weights)
    plain = torch_pipeline.make_fused_predict(
        module, NORMALIZED, compute_dtype=torch.float32, download="pred", device="cpu")
    voted = torch_pipeline.make_fused_predict(
        module, NORMALIZED, compute_dtype=torch.float32, download="pred",
        cc_vote="pallas", device="cpu")
    palette = torch.from_numpy(PALETTE)
    labels = plain(torch.from_numpy(dec), palette)
    ink = torch_output.unpack_bits_device(torch.from_numpy(ink_packed))
    want = np.asarray(cc_vote_batch_xla(labels.numpy().astype(np.int32), ink.numpy(), n_classes=3))
    got = cc_vote_batch(labels, ink, 3, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    fused = voted(torch.from_numpy(dec), palette, torch.from_numpy(ink_packed))
    np.testing.assert_array_equal(fused.numpy(), want)


@pytest.mark.parametrize("cc_vote", ["pallas", "host"])
def test_throughput_run_matches_jax(weights, pages, cc_vote):
    kwargs = dict(host_decimate=8, download="packed", cc_vote=cc_vote, yield_pred=True)
    jax_tp = jax_pipeline.ThroughputPredictor(
        JaxFCNSkip(n_classes=3), weights, PALETTE, PAGE, SCALE,
        compute_dtype=jnp.float32, **kwargs)
    torch_tp = torch_pipeline.ThroughputPredictor(
        _torch_module(weights), None, PALETTE, PAGE, SCALE,
        compute_dtype=torch.float32, device="cpu", **kwargs)
    want = list(jax_tp.run(*pages, batch_size=1))
    got = list(torch_tp.run(*pages, batch_size=1))
    assert len(got) == len(want) == 2
    for (gp, *gtrio), (wp, *wtrio) in zip(got, want):
        agree = gp == wp
        assert agree.mean() >= 0.9999, f"label agreement {agree.mean():.6f}"
        for g, w in zip(gtrio, wtrio):
            np.testing.assert_array_equal(g[agree], w[agree])


def test_staged_calls_and_buffer_ring_match_run(weights, pages):
    tp = torch_pipeline.ThroughputPredictor(
        _torch_module(weights), None, PALETTE, PAGE, SCALE, compute_dtype=torch.float32,
        download="packed", cc_vote="xla", reuse_output_buffers=True, device="cpu")
    run = [tuple(a.copy() for a in trio) for trio in tp.run(*pages, batch_size=1)]
    staged = tp.execute_batch(tp.prep_batch(pages[0][:1], pages[1][:1]))
    listed = tp.execute_batch(tp.prep_pages([pages[0][1]], [pages[1][1]], n_pad=2))
    for g, w in zip(staged, run[0]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(listed, run[1]):
        np.testing.assert_array_equal(g[:1], w)
    assert not listed[2][1].any()  # the pad slot has no ink: its inverted mask is empty


def test_class_pack_is_lsb_first_and_matches_jax():
    pred = np.random.default_rng(2).integers(0, 4, (2, 3, 8)).astype(np.int64)
    pred[0, 0, :4] = [1, 2, 3, 0]  # asymmetric quad: LSB-first byte is 0b00111001
    got = torch_output.pack_classes_device(torch.from_numpy(pred)).numpy()
    assert got[0, 0, 0] == 0b00111001
    np.testing.assert_array_equal(got, np.asarray(jax_output.pack_classes_device(jnp.asarray(pred))))
    np.testing.assert_array_equal(torch_output.unpack_classes(got), pred)


def test_ink_bits_are_msb_first():
    mask = np.random.default_rng(3).random((2, 5, 24)) > 0.5
    mask[0, 0, :8] = [1, 1, 0, 0, 0, 0, 0, 0]  # asymmetric: MSB-first byte is 0xC0
    packed = torch_output.pack_bits_host(mask)
    assert packed[0, 0, 0] == 0xC0
    np.testing.assert_array_equal(packed, jax_output.pack_bits_host(mask))
    np.testing.assert_array_equal(
        torch_output.unpack_bits_device(torch.from_numpy(packed)).numpy(), mask)


def test_unported_options_raise(weights):
    module = _torch_module(weights)
    common = (module, None, PALETTE, PAGE, SCALE)
    # the mesh is ported (tests/test_torch_pipeline_mesh.py): one staged
    # chunk per device, the batch padded to the mesh
    from page_segmentation_tpu_torch.parallel.mesh import make_mesh

    meshed = torch_pipeline.ThroughputPredictor(*common, mesh=make_mesh(2, devices="cpu"),
                                                device="cpu")
    assert [s.tensor.shape[0] for s in meshed._put(np.zeros((3, 4, 4), np.uint8))] == [2, 2]
    # int8 is ported (tests/test_torch_quant.py): it builds the int8 twin
    tp = torch_pipeline.ThroughputPredictor(*common, int8=True, device="cpu")
    assert tp.int8 and tp.amax is None
    with pytest.raises(ValueError, match="packed"):
        torch_pipeline.ThroughputPredictor(FCNSkip(6), None, np.zeros((6, 3), np.uint8),
                                           PAGE, SCALE, download="packed", device="cpu")
