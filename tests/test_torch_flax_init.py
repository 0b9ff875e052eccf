"""flax's fresh weights in the port (``models/flax_init.py``, ``models/
bridge.py`` ``init_variables``) against the JAX package's, on the CPU.

A fresh ``PixelClassifier`` of the port holds, leaf for leaf and bit for
bit, the variables of the JAX package's ``PixelClassifier`` of the same
architecture and seed: glorot-uniform kernels, the ``lecun_normal``
depthwise kernels of mobile_net, zero biases, BatchNorm ones and zeros.
mobile_net and unet are drawn live here (``jax.jit(module.init)``, which
gives the eager init's bytes: ``test_torch_flax_init_effnet.py``),
EfficientNet in ``test_torch_flax_init_effnet.py``; the other models are
held against ``tests/flax_init_digests.json``
(``tests/make_flax_init_digests.py``)."""
import json

import jax
import numpy as np
import pytest
import torch

from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models import bridge, flax_init
from page_segmentation_tpu_torch.models.layers import TFConv
from page_segmentation_tpu_torch.models.registry import Architecture
from tests import make_flax_init_digests as frozen


def assert_same_variables(got, want):
    """Every leaf present in both, of one shape, with the same float32
    bytes; a failure names the leaves and their largest ulp distance."""
    got, want = dict(frozen.leaves(got)), dict(frozen.leaves(want))
    assert set(got) == set(want), set(got) ^ set(want)
    bad = {}
    for path, w in want.items():
        g, w = np.asarray(got[path], np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if g.tobytes() != w.tobytes():
            ulp = np.abs(g.view(np.int32).astype(np.int64) - w.view(np.int32)).max()
            bad["/".join(path)] = (float(np.mean(g == w)), int(ulp))
    assert not bad, bad


@pytest.fixture(scope="module")
def digests():
    with open(frozen.PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("arch, seed", [("mobile_net", 0), ("unet", 3)])
def test_fresh_classifier_holds_the_jax_init(arch, seed):
    """Measured: every leaf bit-equal, the 17 lecun_normal depthwise kernels
    of mobile_net too (100 % of their 64,224 values; no value off by an
    ulp)."""
    want = frozen.jax_variables(arch, seed)
    got = PixelClassifier(3, architecture=Architecture(arch), seed=seed, device="cpu").variables
    assert_same_variables(got, want)


@pytest.mark.parametrize("model", ["fcn_skip", "fcn", "fcn_skip:s2d", "fcn:s2d", "unet",
                                   "res_unet", "image_res_net", "mobile_net"])
def test_fresh_draw_matches_the_frozen_digests(digests, model):
    assert digests["seed"] == frozen.SEED and digests["n_classes"] == frozen.N_CLASSES
    got = frozen.port_variables(model)
    assert frozen.mismatches(got, digests["models"][model], digests["digests"]) == []


def test_draw_does_not_depend_on_the_thread_count():
    """No JAX: one thread and several give the same bytes, with kernels
    larger than one chunk of the pool's work."""
    kernels = [(("a", "conv"), flax_init.LECUN_NORMAL, (3, 3, 96, 1200)),
               (("b",), flax_init.GLOROT_UNIFORM, (3, 3, 512, 320)),
               (("c",), flax_init.LECUN_NORMAL, (3, 3, 1, 32))]
    assert max(np.prod(shape) for _, _, shape in kernels) > 2 * flax_init._CHUNK
    one = flax_init.draw(kernels, 5, threads=1)
    several = flax_init.draw(kernels, 5, threads=4)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(one, several))


def test_kernel_laws_name_the_jax_initializers():
    """glorot_uniform for the Keras-style convs, lecun_normal where the JAX
    family uses flax ``nn.Conv``; a kernel whose layer names no
    initializer cannot be drawn."""
    with torch.device("meta"):
        mobile = Architecture.MOBILE_NET.model(3)
        effnet = Architecture.EFFNETB0.model(3)
    laws = bridge.kernel_laws(mobile)
    assert {p for p, law in laws.items() if law == flax_init.LECUN_NORMAL} == \
        {p for p in laws if p[-1] == "dwconv"}
    assert sum(p[-1] == "dwconv" for p in laws) == 17
    laws = bridge.kernel_laws(effnet)
    for path, law in laws.items():
        lecun = path[0] == "encoder" and path[-1] == "conv"  # _ConvBN: stem, expand, depthwise, project
        assert law == (flax_init.LECUN_NORMAL if lecun else flax_init.GLOROT_UNIFORM), path

    for conv in (torch.nn.Conv2d(1, 2, 3), TFConv(1, 2, (3, 3), kernel_init="he_normal")):
        with pytest.raises(TypeError, match="names no flax initializer"):
            bridge.init_variables(torch.nn.Sequential(conv), 0)


@pytest.mark.parametrize("law", ["lecun_normal", "glorot_uniform"])
@pytest.mark.parametrize("seed, shape", [(0, (3, 3, 1, 32)), (3, (1, 1, 1000, 4003)),
                                         (5, (1, 1, 1, 7)), (9, (5, 5, 40, 60))])
def test_values_are_the_jax_initializers(law, seed, shape):
    """The host library's draw against ``jax.nn.initializers`` on one key:
    4 million values reach both branches of XLA's log1p and every sign of
    the truncated normal; odd sizes leave vector tails."""
    from jax.nn import initializers

    want = np.asarray(getattr(initializers, law)()(jax.random.PRNGKey(seed), shape))
    got = np.empty(int(np.prod(shape)), np.float32)
    native.flax_draw(flax_init.prng_key(seed), flax_init.LAWS.index(law),
                     flax_init.scale(law, shape), 0, got)
    assert got.tobytes() == want.tobytes()
