"""The port's training losses and metrics against the JAX package's on the
same seeded logits, labels, binaries and padding weights (1e-6)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.train import metrics as jax_metrics
from page_segmentation_tpu_torch.train import metrics as port_metrics

FUNCTIONS = ["loss", "jacard_coef_loss", "dice_coef_loss", "categorical_hinge",
             "categorical_focal_loss", "dice_and_categorical",
             "accuracy", "fgpa", "fgpl", "jacard_coef", "dice_coef"]
TAKES_BINARY = {"fgpa", "fgpl"}


def _inputs(weights: str):
    rng = np.random.default_rng(11)
    n, h, w, c = 3, 12, 10, 3
    logits = rng.normal(0.0, 2.0, (n, h, w, c)).astype(np.float32)
    # some logits inside (0, 1), where the focal formula is not clipped flat
    logits[0, :4] = rng.uniform(0.0, 1.0, (4, w, c)).astype(np.float32)
    labels = rng.integers(0, c, (n, h, w)).astype(np.int32)
    binary = (rng.random((n, h, w)) < 0.4).astype(np.uint8)
    if weights == "none":
        return logits, labels, binary, None
    wmap = np.zeros((n, h, w), np.float32)
    wmap[0] = 1.0
    wmap[1, :9, :7] = 1.0  # a padded page
    if weights == "padded":
        wmap[2, :5, :6] = 1.0
    # "all_padding": page 2 is padding only
    return logits, labels, binary, wmap


@pytest.mark.parametrize("weights", ["none", "padded", "all_padding"])
@pytest.mark.parametrize("name", FUNCTIONS)
def test_loss_or_metric_matches_jax(name, weights):
    logits, labels, binary, wmap = _inputs(weights)
    jax_args = [jnp.asarray(labels), jnp.asarray(logits)]
    port_args = [torch.from_numpy(labels), torch.from_numpy(logits)]
    if name in TAKES_BINARY:
        jax_args.append(jnp.asarray(binary))
        port_args.append(torch.from_numpy(binary))
    want = np.asarray(getattr(jax_metrics, name)(
        *jax_args, weights=None if wmap is None else jnp.asarray(wmap)))
    got = getattr(port_metrics, name)(
        *port_args, weights=None if wmap is None else torch.from_numpy(wmap)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_enums_match_jax():
    assert [(m.name, m.value) for m in port_metrics.Loss] == [
        (m.name, m.value) for m in jax_metrics.Loss]
    assert [(m.name, m.value, m.mode, m.is_validation) for m in port_metrics.Monitor] == [
        (m.name, m.value, m.mode, m.is_validation) for m in jax_metrics.Monitor]
    for loss in port_metrics.Loss:
        assert loss().__name__ == jax_metrics.Loss(loss.value)().__name__
