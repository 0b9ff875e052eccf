"""The port's download-race tool (page_segmentation_tpu_torch/tools/
repro_download.py) and its elementwise kernel's plain version, against the
JAX tool (tools/repro_pallas_download.py) and the JAX package's votes, on
the CPU.  Every comparison is exact: both arms compute integers."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu.data.dataset import SingleData
from page_segmentation_tpu.inference.postprocess import vote_connected_component_class
from page_segmentation_tpu.ops.pallas_cc import cc_vote_batch_xla
from page_segmentation_tpu_torch.ops import cuda_add_one
from page_segmentation_tpu_torch.tools import repro_download


def _jax_tool_input(seed):
    """The page of one trial as tools/repro_pallas_download.py:93-96 makes it."""
    rng = np.random.RandomState(seed)
    return (rng.rand(424, 304) > 0.6).astype(np.uint8) * rng.randint(1, 255, (424, 304)).astype(np.uint8)


@pytest.mark.parametrize("seed", [0, 7])
def test_trial_input_is_the_jax_tools(seed):
    np.testing.assert_array_equal(repro_download.trial_input(np.random.RandomState(seed)),
                                  _jax_tool_input(seed))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.int64])
def test_add_one_reference_is_the_jax_tools_expected(dtype):
    x = _jax_tool_input(1).astype(dtype)
    want = x.astype(np.int32) + 1  # the JAX tool's `expected` (:57-58)
    got = cuda_add_one.add_one_reference(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(cuda_add_one.add_one(x, device="cpu").numpy(), want)


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    def no_kernel(x):
        raise AssertionError("the CUDA kernel must not run for a CPU tensor")

    monkeypatch.setattr(cuda_add_one, "_add_one_cuda", no_kernel)
    before = cuda_add_one.launches
    assert cuda_add_one.add_one(np.zeros((2, 3), np.int32), device="cpu").tolist() == [[1] * 3] * 2
    assert cuda_add_one.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_add_one._add_one_cuda(torch.zeros(4, dtype=torch.int32))


def test_real_mode_arms_and_oracle_match_jax():
    """Both arms of the real mode and the host oracle equal the JAX tool's
    Pallas-free vote (cc_vote_batch_xla) and its oracle on the same page."""
    x = _jax_tool_input(3)
    arms, expected = repro_download._arms(simple=False, dev=torch.device("cpu"))
    want = np.asarray(cc_vote_batch_xla(jnp.asarray((x % 3).astype(np.int32))[None],
                                        jnp.asarray(x != 0)[None], n_classes=3))[0]
    oracle = vote_connected_component_class((x % 3).astype(np.int32),
                                            SingleData(binary=(x != 0).astype(np.uint8)))
    np.testing.assert_array_equal(want, oracle)
    np.testing.assert_array_equal(expected(x), oracle)
    for name, fn in arms.items():
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), oracle, err_msg=name)


@pytest.mark.parametrize("simple", [True, False])
def test_main_on_cpu_is_clean(simple, capsys):
    assert repro_download.main(trials=2, simple=simple, device="cpu") == 0
    lines = capsys.readouterr().out.splitlines()
    assert sum(line.endswith(": ok") for line in lines) == 4
    assert "kernel=0/2 plain=0/2" in lines[-1]


@pytest.mark.parametrize("broken", ["kernel", "plain", "both"])
def test_main_fails_only_when_the_kernel_arm_alone_is_corrupt(monkeypatch, broken):
    real_arms = repro_download._arms

    def corrupted(simple, dev):
        arms, expected = real_arms(simple, dev)
        for name in ("kernel", "plain") if broken == "both" else (broken,):
            arms[name] = lambda x, fn=arms[name]: fn(x)[:-1]  # a short download
        return arms, expected

    monkeypatch.setattr(repro_download, "_arms", corrupted)
    failures = repro_download.run(trials=1, simple=True, device="cpu")
    assert failures == {"kernel": broken != "plain", "plain": broken != "kernel"}
    assert repro_download.main(trials=1, simple=True, device="cpu") == (1 if broken == "kernel" else 0)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        repro_download.main(trials=1)
    with pytest.raises(RuntimeError, match="cuda"):
        cuda_add_one.add_one(np.zeros(3, np.int32))
