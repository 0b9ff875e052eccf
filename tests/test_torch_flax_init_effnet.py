"""flax's fresh weights of the EfficientNet family in the port against the
JAX package's, on the CPU (``test_torch_flax_init.py`` holds the others).

Every ``_ConvBN`` kernel of the JAX EfficientNet (stem, expand, depthwise,
project) is a flax ``nn.Conv`` drawn by ``lecun_normal``: a truncated normal
through XLA's float32 ``erf_inv`` and ``log1p``, which the port repeats in
numpy (``models/flax_init.py``).  The slow tests regenerate the frozen
digests of all 16 models live (about 10 to 60 s of JAX init each here) and
show that ``jax.jit(module.init)``, which the live tests and the generator
use, gives the eager init's bytes."""
import json

import numpy as np
import pytest

from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models.registry import Architecture
from tests import make_flax_init_digests as frozen
from tests.test_torch_flax_init import assert_same_variables


@pytest.fixture(scope="module")
def digests():
    with open(frozen.PATH) as f:
        return json.load(f)


def test_fresh_effb0_holds_the_jax_init():
    """Measured: every leaf bit-equal, the 48 lecun_normal kernels too
    (100 % of their 2,919,392 values; no value off by an ulp)."""
    want = frozen.jax_variables("effb0", 0)
    got = PixelClassifier(3, architecture=Architecture.EFFNETB0, seed=0, device="cpu").variables
    assert_same_variables(got, want)


@pytest.mark.parametrize("model", ["effb0", "effb1", "effb2", "effb3"])
def test_fresh_draw_matches_the_frozen_digests(digests, model):
    got = frozen.port_variables(model)
    assert frozen.mismatches(got, digests["models"][model], digests["digests"]) == []


@pytest.mark.slow
@pytest.mark.parametrize("model", frozen.MODELS)
def test_frozen_digests_are_the_live_jax_init(digests, model):
    """The JAX package's live init, digested again, is the frozen entry, and
    the port's draw matches it (every model, effb4-effb7 included)."""
    fresh: list = []
    entry = frozen.entry_for(model, fresh)
    assert frozen.mismatches(frozen.port_variables(model), entry, fresh) == []
    stored = dict(frozen.leaves(digests["models"][model]))
    live = dict(frozen.leaves(entry))
    assert set(stored) == set(live)
    assert all(digests["digests"][stored[p]] == fresh[live[p]] for p in live)


@pytest.mark.slow
@pytest.mark.parametrize("arch", ["unet", "mobile_net", "effb0"])
def test_jit_init_is_eager_init(arch):
    import jax

    from page_segmentation_tpu.inference.classifier import PixelClassifier as JaxClassifier
    from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture

    eager = JaxClassifier(3, JaxArchitecture(arch), seed=0).variables
    eager = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), dict(eager))
    assert_same_variables(frozen.jax_variables(arch, 0), eager)
