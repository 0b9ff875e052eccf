"""The port's ``spatial_forward_batch`` (``parallel/spatial.py``) against
the JAX package's on its virtual CPU devices, on the CPU: a ragged batch of
3 pages over a 2x2 (pages x bands) mesh and over a space axis of size 1
(data parallelism alone, no halo exchange), within the banded path's 5e-4
and with equal argmax, against JAX and the port's own unsplit forward."""
import numpy as np
import pytest
import torch

from page_segmentation_tpu.parallel import spatial as jax_spatial
from page_segmentation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from page_segmentation_tpu_torch.parallel import spatial
from page_segmentation_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_spatial_mesh import _close, _pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("shape", [(2, 2), (2, 1)])
def test_spatial_forward_batch_matches_jax(shape):
    """A ragged batch of 3 pages over (pages x bands) = 2x2, and a space axis
    of size 1 (data parallelism alone, no halo exchange)."""
    jax_module, variables, module, _ = _pair("fcn_skip")
    pages = np.random.RandomState(5).rand(3, 384, 40, 1).astype(np.float32)
    n = int(np.prod(shape))
    mesh = make_mesh(n, shape=shape, axis_names=("data", "space"), devices="cpu")
    jax_mesh = jax_make_mesh(n, shape=shape, axis_names=("data", "space"))
    got = spatial.spatial_forward_batch(module, pages, mesh, margin=96)
    want = jax_spatial.spatial_forward_batch(jax_module, variables, pages, jax_mesh, margin=96)
    with torch.no_grad():
        whole = module(torch.from_numpy(pages)).numpy()
    _close(got, want, whole)
