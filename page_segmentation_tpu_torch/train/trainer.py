"""Training orchestration.

Counterpart of ``page_segmentation_tpu/train/trainer.py``:
``AugmentationSettings``, ``TrainSettings`` (every field, plus ``device``)
and ``Trainer`` with the loop of the reference trainer: per-epoch
validation, checkpoint on improvement, early stopping, reduce-LR-on-plateau
(or a cosine schedule), restore of the best weights, resume from a
checkpoint's optimizer state and loop counters, class-balanced page
sampling and class-weighted loss.

Pages are padded to bucketed shapes and batched per bucket; the padding
carries weight 0 in every objective.  The next batch is built on a prefetch
thread (materialize, augment, pad) and uploaded there from pinned memory on
a side stream (``inference/pipeline.py`` ``DeviceTransfers``); the step
waits for that copy's event before it reads the batch.  Each epoch draws
its shuffle and host augmentation from ``np.random.default_rng([seed,
epoch])``, as the JAX trainer does, so both packages see the same batches
in the same order; device augmentation draws from a ``torch.Generator``
seeded from (seed, epoch).

The live weights are the module's parameters and, for the BatchNorm
families, its buffers; ``Trainer.params`` and ``Trainer.model_state`` read
and write them as the JAX param tree and ``{"batch_stats": ...}`` of numpy
arrays, and checkpoints hold both in flax's layout.  Each epoch's dropout
masks (UNet) come from a ``torch.Generator`` seeded from (seed, epoch).  A
fresh run starts from ``PixelClassifier``'s weights (``init_variables``:
flax's own, so a fresh run of any model starts where the JAX trainer's
does).  ``pretrained_encoder``
loads an encoder from a Keras ``.h5`` or a provisioned encoder directory;
``export_h5`` writes a Keras ``.h5`` beside each checkpoint (h5py).

Several devices, as in the JAX trainer: ``n_devices > 1`` trains
data-parallel over an in-process mesh (``parallel/mesh.py``; the CPU counts
as that many devices when ``device="cpu"``), ``distributed`` over the mesh
of every process (``parallel/distributed.py``, after ``initialize()``).
Batches pad to a multiple of the mesh with zero pages of weight 0.  Across
processes every process loads the same dataset and keeps its strided
shard, padded by wrapping to equal length, and every batch takes one bucket
shape, the dataset's largest, so the processes' steps stay in lockstep;
only process 0 writes scalars, diagnostics and checkpoints.
``checkpoint_backend="orbax"`` also writes the step-versioned asynchronous
checkpoints of ``train/checkpoint.py`` ``OrbaxCheckpointer`` under
``<output_dir>/<model_name>_orbax``, and ``auto_resume`` continues from its
newest step: weights, BatchNorm statistics, optimizer state and the loop's
counters.
"""
from __future__ import annotations

import logging
import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.augment import augment_triple, sample_affine_params
from ..data.dataset import Dataset, entry_shape as _entry_shape, materialize as _materialize
from ..device import resolve_device
from ..models.bridge import params_from_jax, params_to_jax
from ..models.registry import Architecture, Optimizers
from ..ops.pad import bucket_shape, pad_to
from .callbacks import ModelDiagnoser, ScalarLogger, TrainProgressCallback
from .checkpoint import save_checkpoint
from .metrics import Loss, Monitor

logger = logging.getLogger(__name__)


class AugmentationSettings(NamedTuple):
    rotation_range: float = 2.5
    width_shift_range: float = 0.025
    height_shift_range: float = 0.025
    shear_range: float = 0.00
    zoom_range: Sequence[float] = (0.95, 1.05)
    horizontal_flip: bool = False
    vertical_flip: bool = False
    brightness_range: Optional[List[float]] = None

    image_fill_mode: str = "nearest"
    binary_fill_mode: str = "nearest"
    mask_fill_mode: str = "nearest"
    image_cval: int = 0
    binary_cval: int = 0
    mask_cval: int = 0


class TrainSettings(NamedTuple):
    """The JAX package's fields, with its defaults, and ``device``."""

    n_epoch: int
    n_classes: int
    l_rate: float
    train_data: Dataset
    validation_data: Optional[Dataset]
    display: int
    output_dir: str
    threads: int

    data_augmentation: bool = False
    data_augmentation_settings: AugmentationSettings = AugmentationSettings()

    early_stopping_max_performance_drops: int = 10
    early_stopping_restore_best_weights: bool = True
    early_stopping_min_delta: float = 0.0

    reduce_lr_on_plateau: bool = True
    reduce_lr_plateau_factor: float = 0.5
    reduce_lr_min_lr: float = 0.000001

    model_name: str = "model"
    model_suffix: str = ""  # checkpoints are directories
    save_best_model_only: bool = True
    save_weights_only: bool = False

    architecture: Architecture = Architecture.FCN_SKIP
    loss: Loss = Loss.CATEGORICAL_CROSSENTROPY
    monitor: Monitor = Monitor.VAL_LOSS
    optimizer: Optimizers = Optimizers.ADAM

    optimizer_norm_clipping: bool = True
    optimizer_norm_clip_value: float = 1.0
    optimizer_clipping: bool = False
    optimizer_clip_value: float = 1.0
    evaluation_data: Optional[Dataset] = None

    load: Optional[str] = None

    continue_training: bool = False
    compute_baseline: bool = False
    foreground_masks: bool = False
    tensorboard: bool = False  # diagnostics images are PNGs

    image_dimension: int = 1
    gpu_allow_growth: bool = False  # accepted; PyTorch's caching allocator grows anyway

    batch_size: int = 1
    bucket_granularity: int = 1
    compute_dtype: str = "float32"
    n_devices: Optional[int] = None  # data-parallel mesh size (None = one device)
    seed: int = 0
    checkpoint_backend: str = "msgpack"  # or "orbax" (asynchronous, step-versioned)
    device_augmentation: bool = False  # the affine on the device
    remat: bool = False  # recompute the forward in the backward pass
    auto_resume: bool = False  # orbax backend: continue from the newest step
    pretrained_encoder: Optional[str] = None  # a backbone .h5 or encoder directory
    # the mesh of every process; call parallel.distributed.initialize() first
    distributed: bool = False
    # uint8 pixels and masks plus valid dims, normalized on the device
    compact_transfer: bool = True
    export_h5: bool = False  # also write <model_name>.h5 with each checkpoint
    # apply the optimizer once every k steps on the mean of the k
    # micro-batch gradients; 1 = off
    grad_accum: int = 1
    # > 0: a step with a non-finite loss or gradient keeps the params and
    # optimizer state, and training aborts after this many in a row
    skip_nonfinite: int = 0
    # "constant" (ReduceLROnPlateau may lower it) or "cosine" (warmup and
    # cosine decay per applied update; supersedes the plateau reducer)
    lr_schedule: str = "constant"
    lr_warmup_steps: int = 0
    lr_decay_steps: Optional[int] = None  # None = ceil(pages / batch) * n_epoch
    lr_min_fraction: float = 0.0
    # redraw each training epoch's pages (with replacement) weighted by how
    # over-represented their rarest class is; needs eager-loaded masks
    balanced_sampling: bool = False
    balanced_sampling_strength: float = 0.5  # 0 uniform, 1 fully balanced
    # pixel loss scaled by corpus_freq(class) ** -beta, mean pixel weight 1
    class_weighting: float = 0.0
    device: str = "cuda"


def _weighted_means(weighted_metrics) -> dict:
    """Mean of per-batch metric dicts weighted by batch page count."""
    total = float(sum(n for n, _ in weighted_metrics))
    return {
        k: float(sum(n * float(m[k]) for n, m in weighted_metrics)) / total
        for k in weighted_metrics[0][1]
    }


class _NullLogger:
    """The scalar logger of a process that does not write (process > 0)."""

    def log(self, **record) -> None:
        pass

    def close(self) -> None:
        pass


class Trainer:
    def __init__(self, settings: TrainSettings):
        self.settings = s = settings
        self._class_weight_cache = {}
        self._orbax = None  # the versioned checkpointer, made at its first use

        self.mesh = None
        self._multi_host = False
        self._forced_bucket = None
        if s.distributed:
            from ..parallel import distributed

            self.mesh = distributed.global_mesh()
            self._multi_host = distributed.process_count() > 1
        elif s.n_devices and s.n_devices > 1:
            from ..parallel.mesh import make_mesh

            on_cpu = resolve_device(s.device).type == "cpu"
            self.mesh = make_mesh(s.n_devices, devices="cpu" if on_cpu else None)
        self.device = (self.mesh.local_devices[0] if self.mesh is not None
                       else resolve_device(s.device))
        dtype = torch.bfloat16 if s.compute_dtype == "bfloat16" else torch.float32
        self.module = s.architecture.model(s.n_classes, dtype=dtype).to(self.device)
        self.preprocess, self.rgb = s.architecture.preprocess()
        self.loss_fn = s.loss()

        if s.lr_schedule == "constant":
            lr_arg = s.l_rate
        elif s.lr_schedule == "cosine":
            from .optim import warmup_cosine_decay_schedule

            # the schedule advances once per applied update (k micro-steps
            # make one with grad_accum)
            total = s.lr_decay_steps or max(
                1,
                math.ceil(len(s.train_data) / max(1, s.batch_size)) * s.n_epoch
                // max(1, s.grad_accum),
            )
            lr_arg = warmup_cosine_decay_schedule(
                init_value=0.0 if s.lr_warmup_steps else s.l_rate,
                peak_value=s.l_rate,
                warmup_steps=s.lr_warmup_steps,
                decay_steps=max(total, s.lr_warmup_steps + 1),
                end_value=s.l_rate * s.lr_min_fraction,
            )
        else:
            raise ValueError(f"unknown lr_schedule '{s.lr_schedule}'")
        self.optimizer = s.optimizer.make(
            lr_arg,
            norm_clipping=s.optimizer_norm_clipping,
            norm_clip_value=s.optimizer_norm_clip_value,
            value_clipping=s.optimizer_clipping,
            clip_value=s.optimizer_clip_value,
            grad_accum=s.grad_accum,
        )

        # the weights: a checkpoint, or a fresh init when none loads and the
        # run does not continue one
        from ..inference.classifier import PixelClassifier

        try:
            classifier = PixelClassifier(s.n_classes, architecture=s.architecture,
                                         model_path=s.load, seed=s.seed, device="cpu")
        except Exception:
            if s.continue_training:
                raise
            logger.warning(f"Could not load model from {s.load}; training from fresh init")
            classifier = PixelClassifier(s.n_classes, architecture=s.architecture,
                                         seed=s.seed, device="cpu")
        self.params = classifier.params
        self.model_state = classifier.model_state  # batch_stats for the BatchNorm families
        if s.pretrained_encoder:
            from ..models.h5_import import load_encoder_into

            variables = load_encoder_into({"params": self.params, **self.model_state},
                                          s.architecture, s.pretrained_encoder)
            self.params = variables["params"]
            self.model_state = {k: v for k, v in variables.items() if k != "params"}
            logger.info(f"Loaded pretrained encoder from {s.pretrained_encoder}")
        self.opt_state = self.optimizer.init(self._live())

        # resume: optimizer state and loop counters with the weights
        self._resume_meta: Optional[dict] = None
        if s.continue_training and s.load:
            from .checkpoint import load_meta, load_opt_state

            restored = load_opt_state(s.load, template=self.optimizer.state_dict(self.opt_state))
            if restored is not None:
                self.opt_state = self.optimizer.load_state_dict(restored, self.device)
                meta = load_meta(s.load)
                if meta.get("epoch") is not None:
                    self._resume_meta = meta
                logger.info(
                    f"Resumed optimizer state from {s.load} "
                    f"(epoch {meta.get('epoch')}, lr {meta.get('lr', meta.get('l_rate'))})"
                )

        if s.auto_resume and s.checkpoint_backend == "orbax":
            self._try_orbax_resume()

        if self._multi_host:
            self._shard_for_processes()

        # device augmentation warps float images; the compact uint8 layout
        # serves the other paths
        self._compact = s.compact_transfer and not (s.data_augmentation and s.device_augmentation)

        from ..inference.pipeline import DeviceTransfers
        from .steps import make_step_fns

        class_weights = None
        if s.class_weighting:
            freq = self._corpus_class_freq(s.train_data.data)
            raw = np.power(np.maximum(freq, 1e-9), -float(s.class_weighting))
            # mean pixel weight 1 over the train corpus
            class_weights = (raw / max(float((freq * raw).sum()), 1e-9)).astype(np.float32)
            logger.info(f"class weights (beta={s.class_weighting}): "
                        f"{np.round(class_weights, 3).tolist()}")
        self._class_weights = class_weights

        self._train_step, self._eval_step = make_step_fns(
            self.module, self.optimizer, self.loss_fn, mesh=self.mesh, remat=s.remat,
            device_preprocess=s.architecture.device_preprocess(),
            skip_nonfinite=s.skip_nonfinite > 0,
            class_weights=class_weights,
        )
        self._transfers = DeviceTransfers(self.device)
        self._mesh_transfers = {self.device: self._transfers}  # per device of the mesh
        # per epoch: pages, train_s (steps, prefetch overlapped), eval_s, save_s
        self.timings: List[dict] = []

        if len(s.train_data) == 0 and s.n_epoch > 0:
            raise Exception("No training files specified. Maybe set n_iter=0")

        if s.compute_baseline:
            self._log_baseline()

    # ------------------------------------------------------------- resume
    def _try_orbax_resume(self) -> None:
        """Continue from the newest step of the versioned checkpoints if the
        directory has one: weights, BatchNorm statistics, optimizer state
        and the loop counters (epoch, lr, best monitor value, early-stop
        wait)."""
        from .checkpoint import OrbaxCheckpointer

        s = self.settings
        directory = os.path.join(s.output_dir, s.model_name + "_orbax")
        if not os.path.isdir(directory):
            return
        self._orbax = OrbaxCheckpointer(directory)
        restored = self._orbax.restore()
        if restored is None:
            return
        step, state, meta = restored
        variables = state["variables"]
        self.params = variables["params"]
        self.model_state = {k: v for k, v in variables.items() if k != "params"}
        if "opt_state" in state:
            self.opt_state = self.optimizer.load_state_dict(state["opt_state"], self.device)
        self._resume_meta = dict(meta or {})
        self._resume_meta.setdefault("epoch", step)
        logger.info(f"Auto-resumed from step {step} in {directory}")

    def _shard_for_processes(self) -> None:
        """Lockstep across processes: every process must take the same
        number of identically shaped steps per epoch, or the collectives
        deadlock.  So one bucket shape serves the whole (global) dataset,
        and each process keeps its strided shard, the short ones wrapped
        round their own pages to equal length."""
        from ..parallel import distributed

        s = self.settings
        shapes = [bucket_shape(_entry_shape(d), s.architecture.stride_factor, s.bucket_granularity)
                  for d in s.train_data.data]
        self._forced_bucket = (max(h for h, _ in shapes), max(w for _, w in shapes))
        shard = distributed.local_shard(s.train_data.data)
        if not shard:
            raise Exception(
                f"dataset has {len(s.train_data.data)} pages for "
                f"{distributed.process_count()} processes; every process needs at least one"
            )
        target_len = math.ceil(len(s.train_data.data) / distributed.process_count())
        while len(shard) < target_len:  # strided shards differ by <= 1
            shard.append(shard[0])
        self.settings = s._replace(train_data=Dataset(shard, s.train_data.color_map))

    # ------------------------------------------------------------- weights
    @property
    def params(self):
        """The weights as the JAX param tree of numpy arrays."""
        return params_to_jax(self._live())

    @params.setter
    def params(self, tree) -> None:
        self._assign(params_from_jax(tree))

    @property
    def model_state(self) -> dict:
        """Non-param collections: ``{"batch_stats": ...}`` for the
        BatchNorm families, {} for the others."""
        stats = self._live_state()
        return {"batch_stats": params_to_jax(stats)["batch_stats"]} if stats else {}

    @model_state.setter
    def model_state(self, value) -> None:
        if value and "batch_stats" in value:
            self._assign({}, params_from_jax({"params": {}, "batch_stats": value["batch_stats"]}))

    def _live(self) -> dict:
        return dict(self.module.named_parameters())

    def _live_state(self) -> dict:
        """The BatchNorm buffers ({} without BatchNorm)."""
        return dict(self.module.named_buffers())

    def _assign(self, params: dict, state: Optional[dict] = None) -> None:
        """Copy ``params`` (every parameter) and ``state`` (every buffer, when
        given) into the module."""
        with torch.no_grad():
            if params:
                for name, p in self.module.named_parameters():
                    p.copy_(params[name])
            if state is not None:
                for name, b in self.module.named_buffers():
                    b.copy_(state[name])

    # ------------------------------------------------------------- baseline
    def _log_baseline(self):
        """The majority class's share of the training pixels."""
        s = self.settings

        if any(d.mask is None and d.loader is not None for d in s.train_data.data):
            # lazy data: one pass over transient copies, 16 pages at a time
            counts = np.zeros(s.n_classes, np.int64)
            total = 0
            entries = s.train_data.data
            for start in range(0, len(entries), 16):
                for d in _materialize(entries[start : start + 16]):
                    counts += np.bincount(d.mask.ravel(), minlength=s.n_classes)[: s.n_classes]
                    total += d.mask.size
            percentages = list(counts / max(total, 1))
            logging.info(f"Label percentage: {list(zip(range(s.n_classes), percentages))}")
            logging.info(f"Baseline: {max(percentages)}")
            self.baseline = max(percentages)
            return

        def label_percentage(label):
            total = np.sum([d.mask.shape[0] * d.mask.shape[1] for d in s.train_data.data])
            return np.sum([np.sum(d.mask == label) for d in s.train_data.data]) / total

        logging.info(f"Computing label percentage for {len(s.train_data.data)} files.")
        percentages = [label_percentage(l) for l in range(s.n_classes)]
        logging.info(f"Label percentage: {list(zip(range(s.n_classes), percentages))}")
        logging.info(f"Baseline: {max(percentages)}")
        self.baseline = max(percentages)

    # --------------------------------------------------------------- batches
    def _make_batch(self, samples, augment: bool, rng: Optional[np.random.Generator]):
        """A host batch of numpy arrays, padded to the largest bucket."""
        s = self.settings
        samples = _materialize(samples)  # lazy entries load here
        # across processes every batch takes the dataset's largest bucket
        target = self._forced_bucket or (0, 0)
        prepared = []
        for d in samples:
            image, binary, mask = d.image, d.binary, d.mask
            if self.rgb and (image.ndim == 2):
                image = np.stack([image] * 3, axis=-1)
            if binary is None:
                binary = np.full(image.shape[:2], 1, dtype=np.uint8)
            if s.foreground_masks:
                mask = mask.copy()
                mask[binary != 1] = 0
            if augment:
                aug = s.data_augmentation_settings
                params = sample_affine_params(
                    rng,
                    image.shape[:2],
                    rotation_range=aug.rotation_range,
                    width_shift_range=aug.width_shift_range,
                    height_shift_range=aug.height_shift_range,
                    shear_range=aug.shear_range,
                    zoom_range=tuple(aug.zoom_range),
                    horizontal_flip=aug.horizontal_flip,
                    vertical_flip=aug.vertical_flip,
                    brightness_range=aug.brightness_range,
                )
                image, binary, mask = augment_triple(image, binary, mask, params, aug)
            if self._compact:
                # raw uint8 pixels go up; the step normalizes them
                image = np.clip(np.round(np.asarray(image, np.float32)), 0, 255).astype(np.uint8)
            else:
                image = np.asarray(self.preprocess(np.asarray(image, np.float32)), np.float32)
            if image.ndim == 2:
                image = image[..., None]
            prepared.append((image, binary, mask))
            shape = bucket_shape(image.shape[:2], s.architecture.stride_factor, s.bucket_granularity)
            target = (max(target[0], shape[0]), max(target[1], shape[1]))

        n = len(prepared)
        c = prepared[0][0].shape[-1]
        if self._compact:
            batch = {
                "image": np.zeros((n,) + target + (c,), np.uint8),
                "binary": np.zeros((n,) + target, np.uint8),
                "mask": np.zeros((n,) + target, np.uint8),
                "dims": np.zeros((n, 2), np.int32),
            }
            for i, (image, binary, mask) in enumerate(prepared):
                batch["image"][i] = pad_to(image, target)
                batch["binary"][i] = pad_to(binary.astype(np.uint8), target)
                batch["mask"][i] = pad_to(mask.astype(np.uint8), target)
                batch["dims"][i] = image.shape[:2]
        else:
            batch = {
                "image": np.zeros((n,) + target + (c,), np.float32),
                "binary": np.zeros((n,) + target, np.uint8),
                "mask": np.zeros((n,) + target, np.int32),
                "weights": np.zeros((n,) + target, np.float32),
            }
            for i, (image, binary, mask) in enumerate(prepared):
                h, w = image.shape[:2]
                batch["image"][i] = pad_to(image, target)
                batch["binary"][i] = pad_to(binary.astype(np.uint8), target)
                batch["mask"][i] = pad_to(mask.astype(np.int32), target)
                batch["weights"][i, :h, :w] = 1.0
        if self._class_weights is not None and self.mesh is None:
            # a mesh step takes the weights from make_step_fns instead: every
            # key of its batch is split over the shards
            batch["class_weights"] = self._class_weights
        return batch

    def _pad_for_mesh(self, batch, n_dev: Optional[int] = None):
        """Pad the batch dimension to a multiple of ``n_dev`` (default: the
        mesh's data axis); the zero rows carry weight 0, so they add nothing
        to the weighted objectives."""
        n_dev = n_dev or len(self.mesh.axis_devices("data"))
        n = batch["image"].shape[0]
        if n % n_dev == 0:
            return batch
        pad_n = n_dev - n % n_dev
        for key, arr in batch.items():
            batch[key] = np.concatenate([arr, np.zeros((pad_n,) + arr.shape[1:], arr.dtype)])
        return batch

    def _transfers_on(self, device) -> "DeviceTransfers":
        from ..inference.pipeline import DeviceTransfers

        if device not in self._mesh_transfers:
            self._mesh_transfers[device] = DeviceTransfers(device)
        return self._mesh_transfers[device]

    def _put(self, arr, device):
        return self._transfers_on(device).put(arr)

    def _place_batch(self, batch):
        """Start the upload of a host batch (pinned memory, side stream): one
        piece per device of the mesh, or the whole batch on one device."""
        if self._multi_host:
            from ..parallel import distributed

            # the local rows tile the local devices; padded rows weigh 0
            local = self._pad_for_mesh(batch, n_dev=len(self.mesh.axis_devices("data")))
            return distributed.global_batch(self.mesh, local, put=self._put)
        if self.mesh is not None:
            from ..parallel.mesh import shard_batch

            return shard_batch(self.mesh, self._pad_for_mesh(batch), put=self._put)
        return {k: self._transfers.put(v) for k, v in batch.items()}

    def _take_batch(self, staged):
        """The uploaded batch, ordered on the current stream after its copy."""
        if self.mesh is not None:
            return {k: [self._transfers_on(p.tensor.device).take(p) for p in v]
                    for k, v in staged.items()}
        return {k: self._transfers.take(v) for k, v in staged.items()}

    def _corpus_class_freq(self, data) -> "np.ndarray":
        """(n_classes,) pixel frequency over the (eager) train masks."""
        n = self.settings.n_classes
        corpus = np.zeros(n, np.float64)
        for d in data:
            if d.mask is None:
                raise ValueError(
                    "class balancing needs eager-loaded masks "
                    "(streaming/lazy datasets keep pixels on disk)"
                )
            corpus += np.bincount(d.mask.reshape(-1), minlength=n)[:n]
        return corpus / max(1.0, corpus.sum())

    def _page_class_weights(self, data) -> "np.ndarray":
        """Per-page sampling probability: the largest over the page's classes
        of (page's pixel fraction) / (corpus pixel fraction), tempered
        against uniform by ``balanced_sampling_strength``; cached per
        dataset."""
        key = id(data[0]) if data else None
        cached = self._class_weight_cache.get(key)
        if cached is not None and len(cached) == len(data):
            return cached
        n = self.settings.n_classes
        corpus = self._corpus_class_freq(data)
        per_page = np.zeros((len(data), n), np.float64)
        for i, d in enumerate(data):
            counts = np.bincount(d.mask.reshape(-1), minlength=n)[:n]
            per_page[i] = counts / max(1, counts.sum())
        ratios = per_page / np.maximum(corpus, 1e-9)[None, :]
        balanced = np.maximum(ratios.max(axis=1), 1e-3)
        balanced = balanced / balanced.sum()
        strength = float(np.clip(self.settings.balanced_sampling_strength, 0.0, 1.0))
        weights = (1.0 - strength) / len(data) + strength * balanced
        weights = weights / weights.sum()
        self._class_weight_cache = {key: weights}
        return weights

    def _balanced_resample(self, data, rng):
        """An epoch-sized page list drawn with replacement under the
        class-balance weights."""
        weights = self._page_class_weights(data)
        idx = rng.choice(len(data), size=len(data), replace=True, p=weights)
        return [data[i] for i in idx]

    def _bucketed_batches(self, dataset: Dataset, batch_size: int, shuffle_rng=None):
        """Pages grouped by bucket shape, as same-bucket batches; shuffled
        (and, with balanced sampling, redrawn) when ``shuffle_rng`` is
        given."""
        s = self.settings
        data = dataset.data
        if s.balanced_sampling and shuffle_rng is not None:
            data = self._balanced_resample(data, shuffle_rng)
        groups = {}
        for d in data:
            shape = self._forced_bucket or bucket_shape(
                _entry_shape(d), s.architecture.stride_factor, s.bucket_granularity)
            groups.setdefault(shape, []).append(d)
        order = []
        for shape, members in groups.items():
            if shuffle_rng is not None:
                shuffle_rng.shuffle(members)
            for start in range(0, len(members), batch_size):
                order.append(members[start : start + batch_size])
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        return order

    def _augment_on_device(self, batch, generator):
        """The affine on the device; a mesh batch per shard, each with its
        own generator (``generator`` is then a list, one per shard)."""
        from ..data.augment_device import DeviceAugmentConfig, augment_batch_on_device

        if self.mesh is not None:
            pieces = [self._augment_on_device({k: v[i] for k, v in batch.items()}, g)
                      for i, g in enumerate(generator)]
            return {k: [p[k] for p in pieces] for k in batch}

        aug = self.settings.data_augmentation_settings
        cfg = DeviceAugmentConfig(
            rotation_range=aug.rotation_range,
            width_shift_range=aug.width_shift_range,
            height_shift_range=aug.height_shift_range,
            shear_range=aug.shear_range,
            zoom_min=aug.zoom_range[0],
            zoom_max=aug.zoom_range[1],
            horizontal_flip=aug.horizontal_flip,
            vertical_flip=aug.vertical_flip,
        )
        image, binary, mask = augment_batch_on_device(
            generator, batch["image"], batch["binary"], batch["mask"], cfg)
        return {**batch, "image": image, "binary": binary, "mask": mask}

    # ----------------------------------------------------------------- train
    def train(self, callback: Optional[TrainProgressCallback] = None) -> dict:
        s = self.settings
        os.makedirs(s.output_dir, exist_ok=True)
        # across processes only process 0 writes the shared files (scalars,
        # diagnostics, checkpoints); concurrent writers corrupt them
        writer_process = self._writer_process()
        scalars = ScalarLogger(s.output_dir) if writer_process else _NullLogger()
        diagnoser = (
            ModelDiagnoser(os.path.join(s.output_dir, "diagnostics"), s.validation_data.color_map)
            if writer_process and s.tensorboard and s.validation_data is not None
            else None
        )

        if callback:
            callback.init(
                s.n_epoch * len(s.train_data.data), s.early_stopping_max_performance_drops
            )

        monitor = s.monitor
        best_value = np.inf if monitor.mode == "min" else -np.inf
        best_params = None
        wait = 0
        lr = float(s.l_rate)
        history = {"loss": [], "val_loss": [], "lr": []}
        stop = False
        global_step = 0
        start_epoch = 0
        nonfinite_streak = 0

        if self._resume_meta:
            meta = self._resume_meta
            start_epoch = int(meta["epoch"]) + 1
            lr = float(meta.get("lr", lr))
            if s.lr_schedule == "constant":
                # a schedule resumes from the restored update count
                self._set_lr(lr)
            if meta.get("best_value") is not None:
                best_value = float(meta["best_value"])
            wait = int(meta.get("wait", 0))
            global_step = int(meta.get("global_step", 0))
            logger.info(
                f"Resuming at epoch {start_epoch} (lr={lr}, best={best_value}, wait={wait})"
            )

        host_augment = s.data_augmentation and not s.device_augmentation
        device_augment = s.data_augmentation and s.device_augmentation

        def build_batch(samples):
            # on the prefetch thread: the upload of batch k+1 overlaps step k
            return self._place_batch(self._make_batch(samples, augment=host_augment, rng=rng))

        for epoch in range(start_epoch, s.n_epoch):
            t_epoch = time.perf_counter()
            # per-epoch streams: a run resumed at epoch k draws what the
            # uninterrupted run draws there
            rng = np.random.default_rng([s.seed, epoch])
            generator = None
            if device_augment:
                seed = int(np.random.SeedSequence([s.seed, epoch]).generate_state(1)[0])
                if self.mesh is None:
                    generator = torch.Generator(device=self.device)
                    generator.manual_seed(seed)
                else:
                    generator = []
                    for i, device in enumerate(self.mesh.axis_devices("data")):
                        generator.append(torch.Generator(device=device))
                        generator[-1].manual_seed(seed + i)
            dropout_rng = torch.Generator(device=self.device)
            dropout_rng.manual_seed(int(np.random.SeedSequence([s.seed, epoch, 1]).generate_state(1)[0]))
            epoch_metrics = []
            batches = self._bucketed_batches(s.train_data, s.batch_size, shuffle_rng=rng)
            with ThreadPoolExecutor(max_workers=1) as prefetch:
                next_batch = prefetch.submit(build_batch, batches[0])
                for index in range(len(batches)):
                    batch = self._take_batch(next_batch.result())
                    if index + 1 < len(batches):
                        next_batch = prefetch.submit(build_batch, batches[index + 1])
                    if device_augment:
                        batch = self._augment_on_device(batch, generator)
                    new_params, new_state, self.opt_state, step_metrics = self._train_step(
                        self._live(), self._live_state(), self.opt_state, batch, dropout_rng
                    )
                    self._assign(new_params, new_state)
                    skipped_step = False
                    if s.skip_nonfinite:
                        if float(step_metrics["nonfinite"]) > 0:
                            skipped_step = True
                            nonfinite_streak += 1
                            logger.warning(
                                f"step {global_step}: non-finite loss/grads — update "
                                f"skipped ({nonfinite_streak}/{s.skip_nonfinite} consecutive)"
                            )
                            if nonfinite_streak >= s.skip_nonfinite:
                                raise RuntimeError(
                                    f"training diverged: {nonfinite_streak} consecutive "
                                    "non-finite steps (params kept at the last finite state; "
                                    "lower l_rate or enable optimizer clipping)"
                                )
                        else:
                            nonfinite_streak = 0
                    if not skipped_step:
                        # a skipped step's metrics are NaN: keep them out of
                        # the epoch means
                        epoch_metrics.append((len(batches[index]), step_metrics))
                    if callback and not skipped_step:
                        callback.update_loss(
                            global_step,
                            float(step_metrics["loss"]),
                            float(step_metrics["accuracy"]),
                        )
                    global_step += 1

            # means weighted by pages: ragged tail batches are smaller
            if not epoch_metrics:
                raise RuntimeError(
                    "training diverged: every step this epoch was non-finite "
                    "(updates skipped; lower l_rate or enable clipping)"
                )
            train_avg = _weighted_means(epoch_metrics)
            timing = {"epoch": epoch, "pages": sum(len(b) for b in batches),
                      "train_s": time.perf_counter() - t_epoch, "eval_s": 0.0, "save_s": 0.0}
            if s.lr_schedule != "constant":
                lr = self._current_lr()  # the schedule's value after this epoch
            record = {"epoch": epoch, "lr": lr, **train_avg}

            val_avg = None
            if s.validation_data is not None and len(s.validation_data) > 0:
                t0 = time.perf_counter()
                val_avg = self._run_eval(s.validation_data)
                timing["eval_s"] = time.perf_counter() - t0
                record.update({f"val_{k}": v for k, v in val_avg.items()})
                if diagnoser is not None:
                    diagnoser.diagnose(epoch, self._diagnostic_samples(s.validation_data))

            scalars.log(**record)
            history["loss"].append(train_avg["loss"])
            history["lr"].append(lr)
            if val_avg:
                history["val_loss"].append(val_avg["loss"])
            logger.info(f"epoch {epoch}: {record}")

            # monitor, checkpoint, early stop, plateau
            t0 = time.perf_counter()
            current = self._monitor_value(monitor, train_avg, val_avg)
            improved = (
                current < best_value - s.early_stopping_min_delta
                if monitor.mode == "min"
                else current > best_value + s.early_stopping_min_delta
            )
            if improved:
                best_value = current
                wait = 0
                best_params = tuple({k: v.detach().clone() for k, v in live.items()}
                                    for live in (self._live(), self._live_state()))
                if s.save_best_model_only:
                    self._save(best_value, epoch, lr=lr, best_value=best_value, wait=wait,
                               global_step=global_step)
                if callback:
                    callback.next_best(global_step, best_value, wait)
            else:
                wait += 1
                if s.early_stopping_max_performance_drops and wait >= s.early_stopping_max_performance_drops:
                    logger.info(f"Early stopping at epoch {epoch} (wait={wait})")
                    stop = True
                if (
                    s.reduce_lr_on_plateau
                    and s.lr_schedule == "constant"  # a schedule supersedes plateau
                    and wait > 0
                    and wait % max(int(s.early_stopping_max_performance_drops / 2), 1) == 0
                ):
                    new_lr = max(lr * s.reduce_lr_plateau_factor, s.reduce_lr_min_lr)
                    if new_lr < lr:
                        lr = new_lr
                        self._set_lr(lr)
                        logger.info(f"ReduceLROnPlateau: lr -> {lr}")
            if not s.save_best_model_only:
                self._save(current, epoch, lr=lr, best_value=best_value, wait=wait,
                           global_step=global_step)
            timing["save_s"] = time.perf_counter() - t0
            self.timings.append(timing)
            if stop:
                break

        if s.early_stopping_restore_best_weights and best_params is not None:
            self._assign(*best_params)
        scalars.close()
        if self._orbax is not None:
            self._orbax.wait()  # the last step's files are on disk when train() returns
        return history

    # ------------------------------------------------------------------ eval
    def eval(self) -> Optional[dict]:
        s = self.settings
        if s.evaluation_data is None:
            logger.info("Evaluation Dataset in Trainsetting not set! ")
            return None
        if len(s.evaluation_data) == 0:
            logger.info("Empty Dataset. Skipping Evaluation")
            return None
        metrics = self._run_eval(s.evaluation_data)
        logger.info(f"eval: {metrics}")
        return metrics

    def _run_eval(self, dataset: Dataset) -> dict:
        # across processes every process holds the whole validation set, so
        # each page counts once per process: harmless, the metrics are
        # weighted means (duplicates scale numerator and denominator alike)
        results = []
        for samples in self._bucketed_batches(dataset, self.settings.batch_size):
            batch = self._take_batch(self._place_batch(self._make_batch(samples, augment=False, rng=None)))
            results.append((len(samples), self._eval_step(self._live(), self._live_state(), batch)))
        return _weighted_means(results)

    # --------------------------------------------------------------- helpers
    def _monitor_value(self, monitor: Monitor, train_avg: dict, val_avg: Optional[dict]) -> float:
        key = monitor.value
        if monitor.is_validation:
            if val_avg is None:
                return train_avg[key.replace("val_", "")]
            return val_avg[key.replace("val_", "")]
        return train_avg.get(key, train_avg["loss"])

    def _set_lr(self, lr: float) -> None:
        self.optimizer.set_lr(self.opt_state, lr)

    def _current_lr(self) -> float:
        return self.optimizer.current_lr(self.opt_state)

    def _writer_process(self) -> bool:
        if not self._multi_host:
            return True
        from ..parallel import distributed

        return distributed.process_index() == 0

    def _save(self, monitor_value: float, epoch: int, **loop_state) -> None:
        s = self.settings
        if not self._writer_process():
            # params and optimizer state are the same on every process; only
            # one may write the shared checkpoint files
            return
        meta = {
            "architecture": s.architecture.value,
            "n_classes": s.n_classes,
            "monitor": s.monitor.value,
            "monitor_value": float(monitor_value),
            "epoch": epoch,
            "l_rate": s.l_rate,
            # loop counters for an exact resume
            **{k: (float(v) if v is not None else None) for k, v in loop_state.items()},
        }
        variables = {"params": self.params, **self.model_state}
        opt_state = None if s.save_weights_only else self.optimizer.state_dict(self.opt_state)
        if s.checkpoint_backend == "orbax":
            if self._orbax is None:
                from .checkpoint import OrbaxCheckpointer

                self._orbax = OrbaxCheckpointer(os.path.join(s.output_dir, s.model_name + "_orbax"))
            self._orbax.save(epoch, variables, opt_state=opt_state, meta=meta)
        # the msgpack directory is always written: PixelClassifier loads it
        path = os.path.join(s.output_dir, s.model_name + s.model_suffix)
        save_checkpoint(path, variables, meta=meta, opt_state=opt_state)
        if s.export_h5:
            # the reference's interchange artifact: a Keras-legacy .h5
            from ..models.h5_export import save_keras_variables

            save_keras_variables(os.path.join(s.output_dir, s.model_name + ".h5"), variables,
                                 s.architecture)

    def _diagnostic_samples(self, dataset: Dataset):
        for d in dataset.data[:10]:
            d = _materialize([d])[0]
            image = self._make_batch([d], augment=False, rng=None)["image"]
            if image.dtype == np.uint8:  # the compact layout: normalize here
                image = np.asarray(self.preprocess(np.asarray(image, np.float32)), np.float32)
            with torch.no_grad():
                logits = self.module(torch.from_numpy(image).to(self.device))
            h, w = d.image.shape[:2]
            pred = logits[0].argmax(-1).cpu().numpy()[:h, :w]
            yield d.image, d.binary, d.mask, pred
