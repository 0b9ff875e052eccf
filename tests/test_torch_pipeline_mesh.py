"""The port's data-parallel ThroughputPredictor (``mesh=``, four CPU
entries) against ``mesh=None`` and against the JAX package's mesh run on
its virtual CPU devices, on the CPU (float32 on both sides).

Six pages on a 4-device mesh exercise the zero-page padding (dropped after
the download).  The port's mesh trio equals its single-device trio byte
for byte for each download layout and vote placement (the host vote, the
device vote on the labeler); against the JAX mesh run (whose device vote
is its ``xla`` labeler) the labels and every product of them are equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.core.colors import DEFAULT_IMAGE_MAP
from page_segmentation_tpu.inference.pipeline import ThroughputPredictor as JaxThroughput
from page_segmentation_tpu.models.fcn import FCNSkip as JaxFCNSkip
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu_torch.inference.pipeline import ThroughputPredictor
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.ops import cuda_cc
from page_segmentation_tpu_torch.parallel.mesh import make_mesh

PAGE = (400, 296)
SCALE = 6 / 50
N = 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def weights():
    return init_params_numpy(3, seed=0)


@pytest.fixture(scope="module")
def pages():
    rng = np.random.RandomState(0)
    pages = rng.randint(0, 255, (N,) + PAGE).astype(np.uint8)
    return pages, np.where(pages < 128, 0, 255).astype(np.uint8)


def _port(weights, mesh, download, cc_vote):
    module = FCNSkip(3)
    module.load_state_dict(params_from_jax(weights))
    return ThroughputPredictor(module, None, DEFAULT_IMAGE_MAP.palette, PAGE, SCALE,
                               compute_dtype=torch.float32, download=download, cc_vote=cc_vote,
                               mesh=mesh, device="cpu")


@pytest.mark.parametrize("download, cc_vote", [
    ("packed", False), ("color", False), ("pred", True), ("packed", True), ("color", True),
    ("pred", "pallas"), ("packed", "pallas"), ("color", "pallas"),
])
def test_mesh_equals_one_device_and_the_jax_mesh(weights, pages, download, cc_vote):
    mesh = make_mesh(4, devices="cpu")
    single = list(_port(weights, None, download, cc_vote).run(*pages, batch_size=N))
    parallel = _port(weights, mesh, download, cc_vote)
    assert parallel.fused.padded_shape == (48, 40) and len(parallel._put(pages[0][:N])) == 4
    got = list(parallel.run(*pages, batch_size=N))
    assert len(got) == len(single) == 1
    for a, b in zip(got[0], single[0]):
        assert a.shape[0] == N
        np.testing.assert_array_equal(a, b)

    jax_vote = "xla" if cc_vote == "pallas" else cc_vote
    jax_tp = JaxThroughput(JaxFCNSkip(n_classes=3), weights, DEFAULT_IMAGE_MAP.palette, PAGE,
                           SCALE, compute_dtype=jnp.float32, download=download,
                           cc_vote=jax_vote, mesh=jax_make_mesh(4))
    want = list(jax_tp.run(*pages, batch_size=N))
    for a, b in zip(got[0], want[0]):
        np.testing.assert_array_equal(a, b)


def test_staged_calls_on_a_mesh_equal_run(weights, pages):
    """prep_batch / prep_pages + execute_batch (the serving engine's staged
    calls) pad a batch of 3 to the 4 devices and give what run() gives."""
    tp = _port(weights, make_mesh(4, devices="cpu"), "pred", "pallas")
    few = pages[0][:3], pages[1][:3]
    via_run = list(tp.run(*few, batch_size=4))[0]
    via_batch = tp.execute_batch(tp.prep_batch(*few))
    via_pages = tp.execute_batch(tp.prep_pages(list(few[0]), list(few[1]), 3))
    for got in (via_batch, via_pages):
        for a, b in zip(via_run, got):
            np.testing.assert_array_equal(a, b)


def test_cpu_mesh_takes_the_plain_labeler(weights, pages, monkeypatch):
    """On CPU shards the device vote runs the plain labeler (no launch);
    each shard labels its own pages, none are copied to the first device."""
    calls = []
    real = cuda_cc.cc_vote_batch

    def recording(pred, binary, n_classes, device="cuda"):
        calls.append(pred.shape[0])
        return real(pred, binary, n_classes, device=device)

    monkeypatch.setattr(cuda_cc, "cc_vote_batch", recording)
    before = cuda_cc.launches
    list(_port(weights, make_mesh(4, devices="cpu"), "packed", "pallas").run(*pages, batch_size=N))
    assert calls == [2, 2, 2, 2] and cuda_cc.launches == before
