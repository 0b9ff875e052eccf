"""The reference agrees with the port on the CPU at a small page size, and
its pieces do what they say."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import traffic, weights
from benchmark.reference import models
from benchmark.reference import pipeline as ref

PALETTE = np.asarray([[255, 255, 255], [255, 0, 0], [0, 255, 0]], np.uint8)


def _cfg(arch):
    mode, stride = ("gray", 8) if arch == "fcn_skip" else ("torch", 32)
    return dict(architecture=arch, page_shape=[512, 384], scale=6 / 50, stride_factor=stride,
                palette=PALETTE.tolist(), host_decimate=8, preprocess=mode, n_classes=3,
                calibration_pages=0 if arch == "fcn_skip" else 4)


@pytest.mark.parametrize("arch", ["fcn_skip", "effb7"])
def test_the_leaves_are_the_port_modules_state_dict(arch):
    from page_segmentation_tpu_torch.models.registry import Architecture

    with torch.device("meta"):
        module = Architecture(arch).model(3)
    port = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    assert port == {name: shape for name, shape, _ in models.leaves_of(arch, 3)}


@pytest.mark.parametrize("arch", ["fcn_skip", "effb7"])
def test_the_reference_trio_equals_the_ports_in_float32(arch):
    from benchmark.harness import driver

    corpus = driver("corpus")
    cfg = {**_cfg(arch), "dtype": "float32", "cc_vote": "pallas", "download": "packed"}
    pages, binaries = traffic.synthesize_pages(4, cfg["page_shape"], 5)
    state = corpus.seeded_state(cfg, pages, 123, "cpu")
    tp = corpus.build_predictor(cfg, state, "cpu")
    got = [tuple(a[i] for a in trio) for trio in tp.run(pages, binaries, batch_size=2)
           for i in range(2)]
    truths = ref.Predict(cfg, state, "cpu").truths(pages, binaries)
    assert [ref.page_mismatch(g, t, PALETTE, 0.0) for g, t in zip(got, truths)] == [0.0] * 4
    for g, t in zip(got, truths):
        for a, b in zip(g, ref.trio(t.classes, t.ink, PALETTE)):
            np.testing.assert_array_equal(a, b)


def test_the_mismatch_counts_decisive_pixels_only():
    logits = np.zeros((3, 2, 2), np.float32)
    logits[1] = 2.0  # class 1 everywhere, 2 above the others ...
    logits[0, 0, 0] = 1.99  # ... but at one pixel only 0.01 above class 0
    sigma = float(logits.std())
    truth = ref.Truth(np.ones((2, 2), np.uint8), logits, sigma, np.zeros((2, 2), bool))
    right = ref.trio(truth.classes, truth.ink, PALETTE)
    assert ref.page_mismatch(right, truth, PALETTE, 0.05) == 0.0
    wrong = ref.trio(np.zeros((2, 2), np.uint8), truth.ink, PALETTE)
    assert ref.page_mismatch(wrong, truth, PALETTE, 0.05) == 0.75  # the near tie may go either way
    assert ref.page_mismatch(wrong, truth, PALETTE, 0.0) == 1.0
    overlay_off = (right[0], right[0] * 0, right[2])
    assert ref.page_mismatch(overlay_off, truth, PALETTE, 0.05) == 1.0
    assert ref.page_mismatch((right[0][:1],) + right[1:], truth, PALETTE, 0.05) == 1.0
    assert ref.page_mismatch((right[0], right[1][:1], right[2]), truth, PALETTE, 0.05) == 1.0


def test_a_vote_that_hangs_on_near_ties_is_not_decisive():
    logits = np.zeros((3, 1, 5), np.float32)
    logits[1, 0, :3] = 1.0  # three pixels sure of class 1
    logits[2, 0, 3:] = 0.001  # two pixels barely class 2
    ink = np.ones((1, 5), bool)
    truth = ref.Truth(np.ones((1, 5), np.uint8), logits, float(logits.std()), ink)
    # 3 against 2 with 2 unsure pixels: the vote could flip, so nothing counts
    assert not ref.decisive(truth, 0.05).any()
    logits[2, 0, 4] = 0.0
    logits[1, 0, 4] = 1.0  # 4 against 1 with 1 unsure: it stands
    truth = truth._replace(logits=logits, sigma=float(logits.std()))
    assert ref.decisive(truth, 0.05).all()


def test_the_vote_takes_the_majority_of_each_component_ties_to_the_lowest():
    pred = np.array([[1, 1, 2, 0], [2, 0, 0, 0], [0, 0, 2, 1]], np.uint8)
    ink = np.array([[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 1, 1]], bool)
    voted = ref.vote(pred, ink, 3)
    np.testing.assert_array_equal(voted, [[1, 1, 1, 0], [1, 0, 0, 0], [0, 0, 1, 1]])


def test_decimation_rounds_half_up():
    pages = torch.tensor([[[0, 1], [1, 0]], [[0, 1], [0, 0]]], dtype=torch.uint8)
    assert ref.decimate(pages, 2).flatten().tolist() == [1, 0]  # 0.5 -> 1, 0.25 -> 0


def test_pages_and_masks_come_from_the_seed():
    a = traffic.synthesize_pages(3, (400, 300), 2 ** 40 + 7)
    b = traffic.synthesize_pages(3, (400, 300), 2 ** 40 + 7)
    c = traffic.synthesize_pages(3, (400, 300), 8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    pages, binaries = a
    assert set(np.unique(binaries)) == {0, 255}
    assert ((pages == traffic.PAPER) == (binaries == 255)).all()
    labels = traffic.layout_labels(0, (400, 300))
    assert set(np.unique(labels)) == {0, 1, 2} and (labels[binaries[0] == 0] > 0).all()


def test_weights_come_from_the_seed_on_the_device():
    leaves = models.leaves_of("fcn_skip", 3)
    a = weights.make_weights(leaves, 2 ** 33 + 1, "cpu")
    b = weights.make_weights(leaves, 2 ** 33 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert float(a["conv1.weight"].std()) == pytest.approx((2 / 25) ** 0.5, rel=0.2)
