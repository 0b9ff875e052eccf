"""EfficientNet-B0's step, the slowest to compile, against JAX in float64
as ``test_torch_families_steps.py`` holds the other families.  And
EfficientNet's dead tail: eval stops the
encoder at the last skip the decoder reads, and a training step still
updates the tail's BatchNorm statistics (under ``torch.no_grad()``) with
zero gradients for its parameters, as the JAX step does."""
import numpy as np
import pytest
import torch

from page_segmentation_tpu_torch.models.bridge import init_variables_numpy, params_from_jax
from page_segmentation_tpu_torch.models.registry import Architecture
from tests.test_torch_families_steps import _flat, assert_bn_step_matches
from tests.torch_families import nchw, page_input


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_effnet_train_step_matches_jax():
    grads, want_grads, new_stats = assert_bn_step_matches("effb0")
    tail = grads["encoder"]["s6_b0"]
    assert not _flat(tail).any() and not _flat(want_grads["encoder"]["s6_b0"]).any()
    assert np.std(new_stats["encoder"]["s6_b0"]["project"]["bn"]["var"]) > 0


def test_effnet_eval_stops_at_the_last_skip_and_training_updates_the_tail():
    """Eval runs no block after s5_b0's expand; training runs the rest for
    its BatchNorm statistics, without gradients."""
    module = Architecture.EFFNETB0.model(3)
    module.load_state_dict(params_from_jax(init_variables_numpy(module, 0)))
    ran = []
    hooks = [getattr(module.encoder, name).register_forward_hook(lambda m, i, o, n=name: ran.append(n))
             for name in module.encoder.blocks]
    x = nchw(page_input(Architecture.EFFNETB0))
    with torch.no_grad():
        module.forward_nchw(x)
    assert ran == [n for n in module.encoder.blocks if n < "s5_b0"]
    ran.clear()
    tail = module.encoder.s6_b0.project.bn
    module.train()
    module.forward_nchw(x)
    module.eval()
    assert ran[-1] == "s6_b0" and tail.updated_stats is not None
    assert not tail.updated_stats[0].requires_grad
    for h in hooks:
        h.remove()
