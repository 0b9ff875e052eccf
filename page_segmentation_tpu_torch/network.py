"""The ``Network`` facade: the reference's central class, kept for embedders.

Counterpart of ``page_segmentation_tpu/network.py``: model construction and
loading, the per-sample generator contract of ``create_dataset_inputs``,
``train_dataset``, ``evaluate_dataset`` and ``predict_single_data``, over
``PixelClassifier`` and ``Trainer``.  ``device`` (default ``"cuda"``) is
where the classifier and ``evaluate_dataset`` run; ``train_dataset`` runs
where its ``TrainSettings.device`` says.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .data.dataset import Dataset, SingleData
from .inference.classifier import PixelClassifier
from .models.registry import Architecture, Optimizers
from .train.callbacks import TrainProgressCallback
from .train.metrics import Loss


class Network:
    def __init__(
        self,
        type: str,
        n_classes: int = -1,
        model_constructor: Architecture = Architecture.FCN_SKIP,
        l_rate: float = 1e-4,
        has_binary: bool = False,
        foreground_masks: bool = False,
        model: Optional[str] = None,
        continue_training: bool = False,
        input_image_dimension: int = 1,
        optimizer: Optimizers = Optimizers.ADAM,
        optimizer_norm_clipping: bool = True,
        optimizer_norm_clip_value: float = 1.0,
        optimizer_clipping: bool = False,
        optimizer_clip_value: float = 1.0,
        loss_func: Optional[Loss] = None,
        compute_dtype: str = "float32",
        device="cuda",
    ):
        self.type = type
        self.n_classes = n_classes
        self.has_binary = has_binary
        self.foreground_masks = foreground_masks
        self.l_rate = l_rate
        self.optimizer = optimizer
        self.optimizer_norm_clipping = optimizer_norm_clipping
        self.optimizer_norm_clip_value = optimizer_norm_clip_value
        self.optimizer_clipping = optimizer_clipping
        self.optimizer_clip_value = optimizer_clip_value
        self.loss = loss_func or Loss.CATEGORICAL_CROSSENTROPY
        self.continue_training = continue_training
        self.device = device
        self.classifier = PixelClassifier(
            n_classes=n_classes,
            architecture=model_constructor,
            model_path=model,
            compute_dtype=compute_dtype,
            device=device,
        )
        self.architecture = self.classifier.architecture.value

    # ----------------------------------------------------------- data feeds
    def create_dataset_inputs(
        self,
        train_data: Dataset,
        data_augmentation: bool = True,
        data_augmentation_settings=None,
        shuffle: bool = False,
    ):
        """An endless per-sample generator with the reference's contract:
        ({'input_1': image, 'input_2': binary}, {'logits': mask}), each a
        batch of one."""
        from .data.augment import augment_triple, sample_affine_params
        from .train.trainer import AugmentationSettings

        settings = data_augmentation_settings or AugmentationSettings()
        preprocess, rgb = self.classifier.preprocess, self.classifier.rgb
        entries = list(train_data.data)
        rng = np.random.default_rng(0)
        while True:
            if self.type == "train" and shuffle:
                rng.shuffle(entries)
            for d in entries:
                binary, image, mask = d.binary, d.image, d.mask
                if rgb and image.ndim == 2:
                    image = np.stack([image] * 3, axis=-1)
                if binary is None:
                    if image.dtype != np.uint8:
                        raise ValueError("a page without a binary must be uint8")
                    binary = np.full(image.shape[:2], 1, dtype=np.uint8)
                if self.foreground_masks and mask is not None:
                    mask = mask.copy()
                    mask[binary != 1] = 0
                if self.type == "train" and data_augmentation:
                    params = sample_affine_params(
                        rng,
                        image.shape[:2],
                        rotation_range=settings.rotation_range,
                        width_shift_range=settings.width_shift_range,
                        height_shift_range=settings.height_shift_range,
                        shear_range=settings.shear_range,
                        zoom_range=tuple(settings.zoom_range),
                        horizontal_flip=settings.horizontal_flip,
                        vertical_flip=settings.vertical_flip,
                        brightness_range=settings.brightness_range,
                    )
                    image, binary, mask = augment_triple(image, binary, mask, params, settings)
                image_batch = _to_batch(np.asarray(preprocess(np.asarray(image, np.float32))))
                yield (
                    {"input_1": image_batch, "input_2": _to_batch(binary)},
                    {"logits": _to_batch(mask) if mask is not None else None},
                )

    # ------------------------------------------------------------- training
    def train_dataset(self, setting, callback: Optional[TrainProgressCallback] = None):
        from .train.trainer import Trainer

        trainer = Trainer(setting)
        trainer.params = self.classifier.params
        trainer.model_state = self.classifier.model_state
        history = trainer.train(callback=callback)
        self.classifier.variables = {"params": trainer.params, **trainer.model_state}
        self._trainer = trainer
        return history

    def evaluate_dataset(self, eval_data: Dataset):
        from .train.trainer import Trainer, TrainSettings

        settings = TrainSettings(
            n_epoch=0,
            n_classes=self.n_classes,
            l_rate=self.l_rate,
            train_data=eval_data,
            validation_data=None,
            display=0,
            output_dir=".",
            threads=1,
            architecture=self.classifier.architecture,
            loss=self.loss,
            device=self.device,
        )
        trainer = Trainer(settings)
        trainer.params = self.classifier.params
        trainer.model_state = self.classifier.model_state
        return trainer._run_eval(eval_data)

    # ------------------------------------------------------------ inference
    def predict_single_data(self, data: SingleData):
        return self.classifier.predict_single_data(data)

    @property
    def model(self):
        return self.classifier


def _to_batch(img: np.ndarray) -> np.ndarray:
    """A page as a batch of one: (H, W) -> (1, H, W, 1), (H, W, C) -> (1, H, W, C)."""
    if img is None:
        return None
    if img.ndim == 2:
        return img[None, ..., None]
    return img[None]


def tf_backend_allow_growth():
    """Accepted for the reference's API: PyTorch's caching allocator grows
    on demand already."""
