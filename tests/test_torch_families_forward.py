"""The port's model families against the flax modules at small sizes, on
the same inputs and the same weights (carried across by the bridge).

Tolerances: float32 logits agree to 1e-4 of their largest magnitude with
argmax agreement >= 99.9 % (the repo's parity bar).  Random weights at
BatchNorm mean 0 / var 1 explode in the deep families, so the BatchNorm
statistics are first calibrated on the input batch
(``calibrate_batch_stats``) and both sides run with those."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
from page_segmentation_tpu_torch.models.registry import Architecture
from tests.torch_families import calibrated, decisive, nchw, page_input


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FORWARD = ["fcn_skip", "fcn", "unet", "res_unet", "image_res_net", "mobile_net", "effb0", "effb1", "effb7"]


@pytest.mark.parametrize("name", FORWARD)
def test_family_forward_matches_jax(name):
    arch = Architecture(name)
    x = page_input(arch)
    module, variables = calibrated(arch, x)
    jax_module = JaxArchitecture(name).model(3)
    want = np.asarray(jax.jit(jax_module.apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = module(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == x.shape[:3] + (3,)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-4 * scale, np.abs(got - want).max() / scale
    agreement = (got.argmax(-1) == want.argmax(-1)).mean()
    assert agreement >= 0.999, f"{name}: argmax agreement {agreement:.5f}"


@pytest.mark.parametrize("name", ["unet", "mobile_net"])
def test_family_bf16_argmax_agreement(name):
    """bf16 against the JAX module's bf16: >= 99.9 % of the pixels whose
    float32 margin is decisive agree.  Random weights leave many near-ties
    (mobile_net's raw bf16 vs float32 agreement is ~95 % in both packages at
    this size), so the near-ties measure bf16 itself, not the port."""
    arch = Architecture(name)
    x = page_input(arch, seed=3)
    module, variables = calibrated(arch, x, dtype=torch.bfloat16)
    jax_f32 = np.asarray(jax.jit(JaxArchitecture(name).model(3).apply)(variables, jnp.asarray(x)))
    jax_module = JaxArchitecture(name).model(3, dtype=jnp.bfloat16)
    want = np.asarray(jax.jit(jax_module.apply)(variables, jnp.asarray(x, jnp.bfloat16))).argmax(-1)
    with torch.no_grad():
        logits = module(torch.from_numpy(x).to(torch.bfloat16))
    assert logits.dtype == torch.float32
    sure = decisive(jax_f32)
    assert sure.mean() >= 0.3
    agreement = (logits.argmax(-1).numpy() == want)[sure].mean()
    assert agreement >= 0.999, f"{name}: bf16 argmax agreement {agreement:.5f} on decisive pixels"
