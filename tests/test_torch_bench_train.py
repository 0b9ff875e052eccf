"""The port's train step against the benchmark's plain training reference
(``benchmark/reference/train.py``), on the CPU at a small size: UNet and
FCNSkip at 64x48, batch 2, 3 classes, seeded random weights
(``benchmark/weights.py``).  Imports no JAX, so it also runs on the card.

Tolerances, each against float32 rounding on the CPU alone: the port and
the reference run the same float32 arithmetic but not the same kernels
(the port pads inside ``conv2d`` where it can, the reference pads first;
the port's loss runs on NHWC logits, the reference's on NCHW), so sums
reorder and values differ by a few ulp per layer, ~1e-6 relative after
UNet's 23 convolutions.  The gradients' relative L2 errors stay under 1e-4,
100x that, and still 100x under what bf16 gives (~1e-2 and more)."""
import contextlib
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import train_arith, weights
from benchmark.reference import train as ref
from page_segmentation_tpu_torch.models.registry import Architecture, Optimizers
from page_segmentation_tpu_torch.ops import prng
from page_segmentation_tpu_torch.train.metrics import Loss
from page_segmentation_tpu_torch.train.optim import per_leaf_norm_clip
from page_segmentation_tpu_torch.train.steps import make_step_fns

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["fcn_skip", "unet"]
SHAPE = (64, 48)
BATCH = 2
N_CLASSES = 3
LR = 1e-4
# float32 on both sides, different kernels: a few ulp per layer (module docstring)
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the moments are sums of the gradients: the gradients' tolerance
ADAM_RTOL = 1e-4
# Adam moves a weight by lr * mu_hat / (sqrt(nu_hat) + 1e-8): where the
# gradient is ~0 that ratio of two tiny numbers takes its sign and size from
# the gradient's last bits, so the update of such a weight may differ by up
# to 2 lr; over a tensor the updates agree to ~2e-4 (UNet), so 10x that
UPDATE_RTOL = 2e-3
# (mu_after - b1 mu_before) / (1 - b1) in float64 loses the rounding of
# mu's float32 update, ~1e-7 relative of |mu| / |g|
RECOVERY_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    # several test processes share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _batch(seed: int = 5):
    """A compact batch as the trainer uploads it: uint8 pixels and mask, the
    valid rows and columns (the second page padded on both sides)."""
    rng = np.random.default_rng(seed)
    h, w = SHAPE
    image = rng.integers(0, 256, (BATCH, h, w, 1)).astype(np.uint8)
    mask = rng.integers(0, N_CLASSES, (BATCH, h, w)).astype(np.uint8)
    dims = np.array([[h, w], [h - 5, w - 3]], np.int32)
    image[1, h - 5:], image[1, :, w - 3:] = 0, 0
    mask[1, h - 5:], mask[1, :, w - 3:] = 0, 0
    binary = (image[..., 0] < 128).astype(np.uint8)
    return {k: torch.from_numpy(v) for k, v in
            dict(image=image, mask=mask, dims=dims, binary=binary).items()}


def _params(arch: str, seed: int = 11):
    return weights.make_weights(ref.leaves_of(arch, N_CLASSES), seed, "cpu")


def _port(arch: str, params):
    module = Architecture(arch).model(N_CLASSES)
    module.load_state_dict(params)
    optimizer = Optimizers.ADAM.make(LR, norm_clipping=True, norm_clip_value=1.0)
    step, _ = make_step_fns(module, optimizer, Loss.CATEGORICAL_CROSSENTROPY(),
                            device_preprocess=Architecture(arch).device_preprocess())
    return module, optimizer, step


def _key(arch: str, i: int = 0):
    return prng.split(prng.fold_in(prng.prng_key(2 ** 31 + 7), i))[1] if arch == "unet" else None


def _as_ref_key(key):
    return None if key is None else (int(key[0]), int(key[1]))


def _rel(got, want):
    return ref.relative_error(got, want)


# ------------------------------------------------------------ the step
@pytest.mark.parametrize("arch", ARCHS)
def test_the_loss_matches_the_reference(arch):
    params = _params(arch)
    _, _, step = _port(arch, params)
    key = _key(arch)
    loss, _ = step.value_and_grad(params, {}, _batch(), key)
    want, _ = ref.loss_and_grads(arch, params, _batch(), _as_ref_key(key))
    assert abs(float(loss) - float(want)) <= LOSS_RTOL * abs(float(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_every_gradient_matches_the_reference(arch):
    params = _params(arch)
    _, _, step = _port(arch, params)
    key = _key(arch)
    _, grads = step.value_and_grad(params, {}, _batch(), key)
    _, want = ref.loss_and_grads(arch, params, _batch(), _as_ref_key(key))
    assert set(grads) == set(want) == set(params)
    errors = {k: _rel(grads[k], want[k]) for k in want}
    assert max(errors.values()) < GRAD_RTOL, sorted(errors.items(), key=lambda kv: -kv[1])[:3]


@pytest.mark.parametrize("arch", ARCHS)
def test_adam_state_and_weights_over_three_steps(arch):
    """Three steps, each from the port's previous weights and Adam state on
    both sides: the moments, the count and the weights after each.  (Two
    free-running trajectories part within a few steps: Adam's first steps
    move each weight by ~lr * sign(g), so a weight whose gradient is ~0
    moves differently for a last-ulp difference, and the next gradients
    cross ReLU and max-pool boundaries on the other side.)"""
    params = _params(arch)
    _, optimizer, step = _port(arch, params)
    port_params, opt_state = dict(params), optimizer.init(params)
    for i in range(3):
        batch, key = _batch(seed=20 + i), _key(arch, i)
        ref_state = {"count": i, "mu": opt_state["base"]["mu"], "nu": opt_state["base"]["nu"]}
        _, _, ref_params, ref_state = ref.train_step(arch, port_params, batch, _as_ref_key(key),
                                                     ref_state, lr=LR)
        before = port_params
        port_params, _, opt_state, _ = step(port_params, {}, opt_state, batch, key)
        assert int(opt_state["base_count"]) == ref_state["count"] == i + 1
        for k in params:
            assert _rel(opt_state["base"]["mu"][k], ref_state["mu"][k]) < ADAM_RTOL, (i, k)
            assert _rel(opt_state["base"]["nu"][k], ref_state["nu"][k]) < ADAM_RTOL, (i, k)
            moved, want = port_params[k] - before[k], ref_params[k] - before[k]
            assert _rel(moved, want) < UPDATE_RTOL, (i, k)
            assert float((moved - want).abs().max()) <= 2 * LR, (i, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_adam_input_recovers_the_clipped_gradient(arch):
    """What the benchmark's check reads: the gradient a step fed to Adam,
    from its first moment before and after, is the clipped gradient."""
    params = _params(arch)
    _, optimizer, step = _port(arch, params)
    state = optimizer.init(params)
    params1, _, state, _ = step(params, {}, state, _batch(seed=30), _key(arch, 0))
    batch, key = _batch(seed=31), _key(arch, 1)
    _, grads = step.value_and_grad(params1, {}, batch, key)
    clipped = per_leaf_norm_clip(1.0)(grads)
    _, _, after, _ = step(params1, {}, state, batch, key)
    for k in params:
        got = ref.adam_input(state["base"]["mu"][k], after["base"]["mu"][k])
        assert _rel(got, clipped[k]) < RECOVERY_RTOL, k
    norms = [float(torch.linalg.vector_norm(g)) for g in clipped.values()]
    assert max(norms) <= 1.0 + 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_the_update_error_reads_the_ports_step_small_and_no_step_one(arch):
    """What the benchmark's second check reads: the weights' change of the
    port's step against the reference's Adam from the same weights, Adam
    state and the gradient the step fed to Adam is float32 rounding of the
    new weights; weights left as they were read 1, a learning rate 10x off
    reads 0.9."""
    params = _params(arch)
    _, optimizer, step = _port(arch, params)
    state = optimizer.init(params)
    params1, _, state1, _ = step(params, {}, state, _batch(seed=32), _key(arch, 0))
    params2, _, state2, _ = step(params1, {}, state1, _batch(seed=33), _key(arch, 1))
    got = {k: ref.adam_input(state1["base"]["mu"][k], state2["base"]["mu"][k]) for k in params}
    adam = {"count": int(state1["base_count"]), "mu": state1["base"]["mu"],
            "nu": state1["base"]["nu"]}
    # float32 rounding of weight + change, ~1e-7 of the weight, over a
    # change ~lr: ~1e-6 relative
    assert ref.update_error(params1, params2, got, adam) < 1e-4
    assert ref.update_error(params1, params1, got, adam) == pytest.approx(1.0)
    assert ref.update_error(params1, params2, got, adam, lr=10 * LR) == pytest.approx(0.9, rel=1e-3)


def _limit(name: str) -> float:
    """The train cell's limit of the check ``name``."""
    return json.loads((ROOT / "benchmark" / "workloads" / "unet.train.json").read_text())["limits"][name]


@pytest.mark.parametrize("arch", ARCHS)
def test_a_bf16_autocast_step_fails_the_gradient_limit(arch):
    """The cell's control: the same step under bf16 autocast reads over the
    check's limit, where the float32 step reads under it."""
    params = _params(arch)
    _, optimizer, step = _port(arch, params)
    state = optimizer.init(params)
    batch, key = _batch(seed=40), _key(arch, 0)
    ratios = {}
    for name, mode in (("float32", contextlib.nullcontext()),
                       ("bf16", torch.autocast("cpu", dtype=torch.bfloat16))):
        with mode:
            _, _, after, _ = step(params, {}, state, batch, key)
        got = {k: ref.adam_input(state["base"]["mu"][k], after["base"]["mu"][k]) for k in params}
        error, tf32, _, _ = ref.gradient_check(got, arch, params, batch, _as_ref_key(key))
        assert tf32 == 0  # no TF32 on the CPU: the scale is the float32 floor
        ratios[name] = error / max(tf32, ref.FLOAT32_SCALE)
    assert ratios["float32"] < _limit("grad_tf32_ratio") < ratios["bf16"], ratios


# ------------------------------------------------------------- dropout
@pytest.mark.parametrize("layer,channels,stride", [(0, 512, 8), (1, 1024, 16)])
def test_the_dropout_masks_are_the_ports_bit_for_bit(layer, channels, stride):
    """The reference's own threefry, SHA-1 and fold against the port's
    ``dropout`` at UNet's two dropouts, keys as the model derives them."""
    step_key = _key("unet", 3)
    shape = (BATCH, channels, math.ceil(SHAPE[0] / stride), math.ceil(SHAPE[1] / stride))
    port_key = prng.fold_in_static(step_key, (f"Dropout_{layer}", 1))
    assert ref.layer_key(_as_ref_key(step_key), layer) == (int(port_key[0]), int(port_key[1]))
    x = torch.rand(shape) + 0.5
    got = prng.dropout(x, 0.5, port_key)
    want = ref.dropout(x, ref.layer_key(_as_ref_key(step_key), layer))
    assert torch.equal(got != 0, ref.keep_mask(_as_ref_key(port_key), shape, 0.5, "cpu"))
    assert torch.equal(got, want)
    assert 0.45 < float((got != 0).float().mean()) < 0.55


def test_the_references_sha1_is_sha1():
    import hashlib

    for message in (b"", b"abc", b"Dropout_0\x01", b"x" * 55, b"y" * 56, b"z" * 200):
        assert ref.sha1(message) == hashlib.sha1(message).digest()


# -------------------------------------------------------------- counts
def test_the_step_flops_count_forward_and_backward():
    """A step is the forward and about twice it again, less the first
    convolution's input gradient; UNet at the cell's page is ~655 GFLOP."""
    from benchmark import arith

    for arch, channels in (("fcn_skip", 1), ("unet", 1)):
        shape = (1, channels) + SHAPE
        forward = arith.forward_flops(arch, N_CLASSES, shape) if arch == "fcn_skip" else None
        step = train_arith.step_flops(arch, N_CLASSES, shape)
        if forward is not None:
            assert 2.5 * forward < step < 3.0 * forward
    unet = train_arith.step_flops("unet", N_CLASSES, (1, 1, 432, 304))
    assert 640e9 < unet < 670e9


def test_the_dropout_bytes_of_a_unet_step():
    # (16, 512, 54, 38) and (16, 1024, 27, 19) float32, read and written, forward and backward
    assert train_arith.dropout_bytes("unet", 16, (432, 304)) == 4 * 4 * 16 * (512 * 54 * 38
                                                                             + 1024 * 27 * 19)
    assert train_arith.dropout_bytes("fcn_skip", 16, (424, 304)) == 0


# ------------------------------------------- the update, batched or not
def _per_tensor_update(kind, grads, state, params):
    """Keras clipnorm 1.0 and optax's Adam, Nadam (``scale_by_adam(nesterov=
    True)``) or Adamax one tensor at a time, in the order ``train/optim.py``
    runs them over all tensors at once."""
    count = state["base_count"] + 1

    def correction(decay, count):
        return 1 - torch.pow(torch.full((), decay, device=count.device), count.to(torch.float32))

    c1, c2, c1_next = correction(0.9, count), correction(0.999, count), correction(0.9, count + 1)
    new, mu, nu = {}, {}, {}
    for k, g in grads.items():
        norm = torch.sqrt((g * g).sum())
        g = g * torch.where(norm > 1.0, 1.0 / (norm + 1e-12), 1.0)
        mu[k] = (1 - 0.9) * g + 0.9 * state["base"]["mu"][k]
        if kind == "adamax":
            nu[k] = torch.maximum(g.abs() + 1e-8, 0.999 * state["base"]["nu"][k])
            direction = (mu[k] / c1) / nu[k]
        else:
            nu[k] = (1 - 0.999) * (g * g) + 0.999 * state["base"]["nu"][k]
            mu_hat = (0.9 * (mu[k] / c1_next) + (1 - 0.9) * (g / c1) if kind == "nadam"
                      else mu[k] / c1)
            direction = mu_hat / (torch.sqrt(nu[k] / c2 + 0.0) + 1e-8)
        new[k] = params[k] + (-1 * state["learning_rate"]) * direction
    return new, mu, nu


@pytest.mark.parametrize("kind", ["adam", "nadam", "adamax"])
@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_the_batched_update_is_the_per_tensor_update_bit_for_bit(device, kind):
    """Clip, the Adam family's rules and the new weights run over all
    tensors at once (``torch._foreach_*``, one launch for many tensors on
    the card): each element gets the same float32 operations in the same
    order as one tensor at a time, so the same bits."""
    from page_segmentation_tpu_torch.train.steps import add_updates

    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    params = {k: v.to(device) for k, v in _params("unet").items()}
    rng = torch.Generator().manual_seed(3)
    optimizer = Optimizers(kind).make(LR)
    state = optimizer.init(params)
    for i in range(3):
        grads = {k: (torch.randn(v.shape, generator=rng) * 10 ** (i - 2)).to(device)
                 for k, v in params.items()}
        want, mu, nu = _per_tensor_update(kind, grads, state, params)
        updates, state = optimizer.update(grads, state, params)
        got = add_updates(params, updates)
        for k in params:
            assert torch.equal(state["base"]["mu"][k], mu[k]), (i, k)
            assert torch.equal(state["base"]["nu"][k], nu[k]), (i, k)
            assert torch.equal(got[k], want[k]), (i, k)
        params = got
