"""The port's multi-process layer (``parallel/distributed.py``) over gloo
on the CPU: 2 processes, each driving 2 CPU devices of a 4-device global
mesh, spawned once for the file (``tests/_torch_dist_worker.py``), with a
timeout of their own; a failed worker gets its peer reaped.

One data-parallel step on an 8-page global batch (each process feeds its
strided rows): the losses agree across the processes and with the
single-device step on the whole batch, the port's and the JAX package's
(same weights), and the new parameters equal the single-device step's.
Then one ``Trainer(distributed=True)`` epoch on 9 pages: unequal strided
shards (5 and 4, the short one wrapped), one forced bucket, equal losses on
both processes, and only process 0 writes files."""
import json
import os
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from page_segmentation_tpu.models.fcn import FCNSkip as JaxFCNSkip
from page_segmentation_tpu.train.metrics import Loss as JaxLoss
from page_segmentation_tpu.train.steps import make_step_fns as jax_make_step_fns
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax
from page_segmentation_tpu_torch.models.fcn import FCNSkip
from page_segmentation_tpu_torch.models.registry import Optimizers
from page_segmentation_tpu_torch.train import metrics
from page_segmentation_tpu_torch.train.steps import make_step_fns
from tests._torch_dist_worker import LR, global_pages

WORKER = os.path.join(os.path.dirname(__file__), "_torch_dist_worker.py")
TIMEOUT = 180


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def workers(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist")
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, WORKER, coordinator, "2", str(pid), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for pid in range(2)]
    deadline = time.monotonic() + TIMEOUT
    failure = None
    while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
        if any(p.poll() not in (None, 0) for p in procs):
            break  # a peer failed: the survivor would wait in a collective
        time.sleep(0.2)
    for pid, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            failure = failure or f"worker {pid} did not finish in {TIMEOUT} s"
        _, err = p.communicate()
        if p.returncode not in (0, None) and failure is None:
            failure = f"worker {pid} failed ({p.returncode}):\n{err[-3000:]}"
    if failure:
        raise RuntimeError(failure)
    results = [json.loads((out / f"result_{pid}.json").read_text()) for pid in range(2)]
    params = [dict(np.load(out / f"params_{pid}.npz")) for pid in range(2)]
    return out, results, params


def test_step_losses_agree_across_processes_and_with_one_device(workers):
    _, results, params = workers
    assert [r["rows"] for r in results] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    losses = [r["loss"] for r in results]
    assert np.isfinite(losses[0])
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)

    batch = global_pages()
    params_np = init_params_numpy(2, seed=0)
    torch.set_num_threads(1)
    popt = Optimizers.SGD.make(LR)
    step, _ = make_step_fns(FCNSkip(2), popt, metrics.loss)
    start = params_from_jax(params_np)
    want_params, _, _, want = step(start, {}, popt.init(start),
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(losses[0], float(want["loss"]), rtol=1e-5)
    for k, v in want_params.items():
        for got in params:
            delta, ref = got[k] - start[k].numpy(), v.numpy() - start[k].numpy()
            assert np.linalg.norm(delta - ref) <= 1e-4 * np.linalg.norm(ref) + 1e-9, k

    jax_step, _ = jax_make_step_fns(JaxFCNSkip(n_classes=2), optax.sgd(LR),
                                    JaxLoss.CATEGORICAL_CROSSENTROPY(), donate=False)
    jp = jax.tree_util.tree_map(jnp.asarray, params_np)
    _, _, _, jax_metrics = jax_step(jp, {}, optax.sgd(LR).init(jp), batch, jax.random.PRNGKey(1))
    np.testing.assert_allclose(losses[0], float(jax_metrics["loss"]), rtol=1e-5)


def test_trainer_lockstep_across_processes(workers):
    out, results, _ = workers
    assert [r["shard_pages"] for r in results] == [5, 5]  # 5 and 4, the short one wrapped
    assert results[0]["forced_bucket"] == results[1]["forced_bucket"] == [32, 32]
    for key in ("trainer_loss", "val_loss"):
        assert np.isfinite(results[0][key]).all()
        np.testing.assert_allclose(results[0][key], results[1][key], rtol=1e-6)
    lines = (out / "run" / "scalars.jsonl").read_text().splitlines()
    assert len(lines) == 1  # written once, by process 0
    assert (out / "run" / "model" / "params.msgpack").exists()
