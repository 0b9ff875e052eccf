"""The port's data-parallel predict executor (``parallel/executor.py``
``ParallelPredictor``, ``train/steps.py`` ``make_forward_fn(mesh=...)``)
against the JAX package's on its virtual CPU devices, on the CPU.

Same weights on both sides (seeded, carried by the bridge):
labels equal the JAX executor's and the port's single-device argmax, for a
full batch, a ragged one (padded with zero pages, cropped back) and an RGB
family (the gray page repeated to 3 channels before its preprocess)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.parallel.executor import ParallelPredictor as JaxParallelPredictor
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu_torch.data.dataset import SingleData
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.parallel.executor import ParallelPredictor
from page_segmentation_tpu_torch.parallel.mesh import make_mesh, shard_batch
from page_segmentation_tpu_torch.train.steps import make_forward_fn


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _nets(name="fcn_skip", n_classes=3):
    """The port's classifier with seeded weights, and the JAX executor's view
    of a classifier (module, variables, preprocess) with the same ones."""
    net = PixelClassifier(n_classes, architecture=Architecture(name), device="cpu")
    net.variables = init_variables_numpy(net.module, 0)
    preprocess, rgb = JaxArchitecture(name).preprocess()
    jax_net = SimpleNamespace(module=JaxArchitecture(name).model(n_classes),
                              variables=net.variables, preprocess=preprocess, rgb=rgb)
    return jax_net, net


@pytest.mark.parametrize("n", [8, 6])
def test_predict_batch_matches_jax_and_one_device(n):
    jax_net, net = _nets()
    images = (np.random.RandomState(n).rand(n, 32, 48) * 255).astype(np.uint8)
    got = ParallelPredictor(net, make_mesh(4, devices="cpu")).predict_batch(images)
    want = JaxParallelPredictor(jax_net, jax_make_mesh(4)).predict_batch(images)
    with torch.no_grad():
        x = torch.from_numpy((images.astype(np.float32) / 255.0)[..., None])
        single = net.module(x).argmax(-1).numpy()
    assert got.shape == (n, 32, 48)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_rgb_family_matches_jax_and_the_single_path():
    jax_net, net = _nets("mobile_net")
    images = np.random.RandomState(0).randint(0, 256, (2, 64, 64)).astype(np.uint8)
    got = ParallelPredictor(net, make_mesh(2, devices="cpu")).predict_batch(images)
    want = JaxParallelPredictor(jax_net, jax_make_mesh(2)).predict_batch(images)
    single = np.stack([net.predict_single_data(SingleData(image=img))[2] for img in images])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


def test_forward_fn_with_given_variables_equals_the_modules_own():
    _, net = _nets()
    mesh = make_mesh(2, devices="cpu")
    x = shard_batch(mesh, {"x": np.random.RandomState(1).rand(4, 16, 16, 1).astype(np.float32)})["x"]
    forward = make_forward_fn(net.module, mesh)
    own = forward(None, x)
    given = forward({k: v.clone() for k, v in net.module.state_dict().items()}, x)
    assert len(own) == len(given) == 2
    for a, b in zip(own, given):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with torch.no_grad():
        np.testing.assert_array_equal(make_forward_fn(net.module)(None, x[0]).numpy(),
                                      own[0].numpy())
