"""The port's entry points that make a fresh model start from the JAX
package's weights, on the CPU: a fresh ``Trainer`` and ``Network``
(mobile_net, seed 0), ``load_encoder_into`` of a provisioned encoder
directory (encoder imported, decoder fresh), and ``derived_margin``, which
measures a family's halo on flax's ``PRNGKey(0)`` draw as the JAX package
does."""
import numpy as np
import pytest

from page_segmentation_tpu.models import h5_import as jax_h5_import
from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
from page_segmentation_tpu.parallel import spatial as jax_spatial
from page_segmentation_tpu_torch.core.colors import ColorMap
from page_segmentation_tpu_torch.data.dataset import Dataset, SingleData
from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
from page_segmentation_tpu_torch.models.h5_import import load_encoder_into
from page_segmentation_tpu_torch.models.registry import Architecture
from page_segmentation_tpu_torch.network import Network
from page_segmentation_tpu_torch.parallel import spatial
from page_segmentation_tpu_torch.tools import provision_pretrained
from page_segmentation_tpu_torch.train.metrics import Monitor
from page_segmentation_tpu_torch.train.trainer import Trainer, TrainSettings
from tests import make_flax_init_digests as frozen
from tests.test_torch_flax_init import assert_same_variables

THREE_CLASSES = {"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text"),
                 "(0, 0, 255)": (2, "image")}


@pytest.fixture(scope="module")
def jax_mobile_net():
    """The JAX package's fresh mobile_net variables, seed 0."""
    return frozen.jax_variables("mobile_net", 0)


def _dataset():
    rng = np.random.RandomState(0)
    image = rng.randint(0, 256, (64, 64, 3)).astype(np.uint8)
    binary = (rng.rand(64, 64) > 0.5).astype(np.uint8)
    mask = np.full((64, 64, 3), 255, np.uint8)
    return Dataset([SingleData(image=image, binary=binary, mask=mask)], ColorMap(THREE_CLASSES))


def test_fresh_trainer_and_network_hold_the_jax_init(jax_mobile_net, tmp_path):
    trainer = Trainer(TrainSettings(
        n_epoch=1, n_classes=3, l_rate=1e-3, train_data=_dataset(), validation_data=None,
        display=10, output_dir=str(tmp_path), threads=1, architecture=Architecture.MOBILE_NET,
        monitor=Monitor.LOSS, device="cpu"))
    assert_same_variables({"params": trainer.params, **trainer.model_state}, jax_mobile_net)
    network = Network("train", n_classes=3, model_constructor=Architecture.MOBILE_NET, device="cpu")
    assert_same_variables(network.classifier.variables, jax_mobile_net)


def test_provisioned_encoder_over_fresh_weights_is_the_jax_packages(jax_mobile_net, tmp_path):
    tf = pytest.importorskip("tensorflow")
    tf.keras.utils.set_random_seed(13)
    h5 = tmp_path / "mobilenet.h5"
    tf.keras.applications.MobileNetV2(weights=None, include_top=False,
                                      input_shape=(96, 96, 3)).save(str(h5))
    encoder = tmp_path / "encoder"
    assert provision_pretrained.main([str(h5), "--out", str(encoder)]) == 0
    fresh = PixelClassifier(3, architecture=Architecture.MOBILE_NET, device="cpu").variables
    got = load_encoder_into(fresh, Architecture.MOBILE_NET, str(encoder))
    want = jax_h5_import.load_encoder_into(jax_mobile_net, JaxArchitecture.MOBILE_NET, str(encoder))
    assert_same_variables(got, want)
    # the encoder is the checkpoint's, the decoder the fresh draw's
    assert not np.array_equal(got["params"]["encoder"]["stem"]["conv"]["kernel"],
                              fresh["params"]["encoder"]["stem"]["conv"]["kernel"])
    assert np.array_equal(got["params"]["up0"]["kernel"], fresh["params"]["up0"]["kernel"])


@pytest.mark.parametrize("arch", ["fcn_skip", "mobile_net"])
def test_derived_margin_measures_the_flax_draw(jax_mobile_net, arch):
    """The JAX package measures on ``module.init(PRNGKey(0), ...)``; its
    mobile_net variables come from the fixture's jitted init (the same
    bytes, ``test_torch_flax_init_effnet.py``) to spare an eager init."""
    variables = jax_mobile_net if arch == "mobile_net" else None
    want = jax_spatial.derived_margin(JaxArchitecture(arch), variables)
    assert spatial.derived_margin(Architecture(arch)) == want
