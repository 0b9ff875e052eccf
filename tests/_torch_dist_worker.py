"""Worker process of ``test_torch_distributed.py``: one of 2 processes over
gloo, each driving 2 CPU devices of a 4-device global mesh.  It takes one
data-parallel train step on its strided rows of an 8-page global batch,
then trains one epoch through ``Trainer(distributed=True)`` on 9 pages
(unequal strided shards, 5 and 4), and writes what it saw as JSON.

    python tests/_torch_dist_worker.py HOST:PORT N_PROCESSES PROCESS_ID OUT_DIR
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from page_segmentation_tpu_torch.core.colors import ColorMap  # noqa: E402
from page_segmentation_tpu_torch.data.dataset import Dataset, SingleData  # noqa: E402
from page_segmentation_tpu_torch.models.bridge import init_params_numpy, params_from_jax  # noqa: E402
from page_segmentation_tpu_torch.models.fcn import FCNSkip  # noqa: E402
from page_segmentation_tpu_torch.models.registry import Optimizers  # noqa: E402
from page_segmentation_tpu_torch.parallel import distributed  # noqa: E402
from page_segmentation_tpu_torch.train import metrics  # noqa: E402
from page_segmentation_tpu_torch.train.metrics import Monitor  # noqa: E402
from page_segmentation_tpu_torch.train.steps import make_step_fns  # noqa: E402
from page_segmentation_tpu_torch.train.trainer import Trainer, TrainSettings  # noqa: E402

H = W = 32
N_GLOBAL = 8
LR = 0.5


def global_pages():
    """The deterministic global batch every process knows."""
    rng = np.random.RandomState(0)
    return {"image": rng.rand(N_GLOBAL, H, W, 1).astype(np.float32),
            "mask": rng.randint(0, 2, (N_GLOBAL, H, W)).astype(np.int32),
            "binary": np.ones((N_GLOBAL, H, W), np.uint8),
            "weights": np.ones((N_GLOBAL, H, W), np.float32)}


def train_pages(count, offset=0):
    pages = []
    for i in range(count):
        mask = np.zeros((H, W), np.uint8)
        mask[8:24, 8:24] = 1
        image = np.where(mask == 1, 200, 10 + i + offset).astype(np.uint8)
        pages.append(SingleData(image=image, binary=(mask == 1).astype(np.uint8), mask=mask))
    return pages


def main():
    coordinator, n_processes, pid, out_dir = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    distributed.initialize(coordinator, n_processes, pid, local_device_ids=[0, 1], device="cpu",
                           initialization_timeout=120, heartbeat_timeout_seconds=120)
    mesh = distributed.global_mesh()
    assert distributed.process_count() == n_processes and mesh.devices.size == 2 * n_processes

    popt = Optimizers.SGD.make(LR)
    train_step, _ = make_step_fns(FCNSkip(2), popt, metrics.loss, mesh=mesh)
    params = params_from_jax(init_params_numpy(2, seed=0))
    batch = global_pages()
    rows = distributed.local_shard(list(range(N_GLOBAL)))
    local = distributed.global_batch(mesh, {k: v[rows] for k, v in batch.items()})
    distributed.barrier("step")
    new_params, _, _, step_metrics = train_step(params, {}, popt.init(params), local)
    np.savez(os.path.join(out_dir, f"params_{pid}.npz"),
             **{k: v.numpy() for k, v in new_params.items()})

    cmap = ColorMap({"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text")})
    trainer = Trainer(TrainSettings(
        n_epoch=1, n_classes=2, l_rate=1e-3, train_data=Dataset(train_pages(9), cmap),
        validation_data=Dataset(train_pages(2, offset=50), cmap), display=10,
        output_dir=os.path.join(out_dir, "run"), threads=1, monitor=Monitor.LOSS,
        early_stopping_max_performance_drops=0, reduce_lr_on_plateau=False, batch_size=4,
        distributed=True, device="cpu"))
    history = trainer.train()
    with open(os.path.join(out_dir, f"result_{pid}.json"), "w") as f:
        json.dump({"loss": float(step_metrics["loss"]), "rows": rows,
                   "shard_pages": len(trainer.settings.train_data),
                   "forced_bucket": list(trainer._forced_bucket),
                   "trainer_loss": history["loss"], "val_loss": history["val_loss"]}, f)
    distributed.shutdown()


if __name__ == "__main__":
    main()
