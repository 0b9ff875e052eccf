"""Training losses and metrics on tensors.

Counterpart of ``page_segmentation_tpu/train/metrics.py``, formula for
formula.  Every objective takes float32 NHWC ``logits`` (N, H, W, C), as
the port's ``FCNSkip.forward`` returns them, and integer ``labels``
(N, H, W) or (N, H, W, 1):

* ``loss``: mean sparse softmax cross-entropy;
* ``accuracy``: mean(labels == argmax logits);
* ``jacard_coef`` / ``dice_coef``: softmax against one-hot, smoothing 100,
  per class; their losses are mean(-log(coef));
* ``categorical_hinge``, ``dice_and_categorical``, and
  ``categorical_focal_loss``, which applies the focal formula to the raw
  logits clipped to (eps, 1 - eps), as the JAX package does;
* ``fgpa`` / ``fgpl``: accuracy and cross-entropy on the foreground (ink)
  pixels of the binary.

Batches are padded to bucketed shapes, so every objective takes an optional
``weights`` map (N, H, W), 0 on padding: the formulas then run over the
valid pixels only, and pages that are all padding drop out of the per-page
means (``page_validity``).
"""
from __future__ import annotations

import enum

import torch
import torch.nn.functional as F

EPSILON = 1e-7  # Keras' backend epsilon


def _squeeze_labels(labels: torch.Tensor) -> torch.Tensor:
    if labels.ndim == 4 and labels.shape[-1] == 1:
        labels = labels[..., 0]
    return labels.long()


def _wmean(values: torch.Tensor, weights) -> torch.Tensor:
    if weights is None:
        return values.mean()
    weights = weights.to(values.dtype)
    return (values * weights).sum() / weights.sum().clamp_min(1.0)


def sparse_softmax_ce(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0]


def loss(labels, logits, weights=None):
    return _wmean(sparse_softmax_ce(_squeeze_labels(labels), logits), weights)


def accuracy(labels, logits, weights=None):
    labels = _squeeze_labels(labels)
    correct = (labels == logits.argmax(dim=-1)).to(torch.float32)
    return _wmean(correct, weights)


def page_validity(weights):
    """Per-page 0/1 validity from a padding-weights map (None -> None):
    pages that are all padding contribute nothing to per-page means."""
    if weights is None:
        return None
    return (weights.to(torch.float32).sum(dim=(1, 2)) > 0).to(torch.float32)


def _valid_page_mean(per_page: torch.Tensor, valid) -> torch.Tensor:
    """Mean over pages, restricted to the valid ones when a mask is given."""
    if valid is None:
        return per_page.mean(dim=0)
    shaped = valid.reshape((-1,) + (1,) * (per_page.ndim - 1))
    return (per_page * shaped).sum(dim=0) / valid.sum().clamp_min(1.0)


def _binary_2d(binary: torch.Tensor) -> torch.Tensor:
    if binary.ndim == 4 and binary.shape[-1] == 1:
        binary = binary[..., 0]
    return binary


def fgpa(labels, logits, binary, weights=None):
    """Foreground pixel accuracy, per page, then the valid pages' mean."""
    labels = _squeeze_labels(labels)
    equals = (labels == logits.argmax(dim=-1)).to(torch.float32)
    fg = _binary_2d(binary).to(torch.float32)
    if weights is not None:
        fg = fg * weights.to(torch.float32)
    correct = (equals * fg).sum(dim=(1, 2))
    total = fg.sum(dim=(1, 2))
    return _valid_page_mean(correct / total.clamp_min(1.0), page_validity(weights))


def fgpl(labels, logits, binary, weights=None):
    """Cross-entropy with labels and logits multiplied by the binary."""
    labels = _squeeze_labels(labels)
    fg = _binary_2d(binary).to(torch.float32)
    masked_labels = (labels.to(torch.float32) * fg).long()
    masked_logits = logits * fg[..., None]
    return _wmean(sparse_softmax_ce(masked_labels, masked_logits), weights)


def _soft_one_hot(labels, logits, weights):
    n_classes = logits.shape[-1]
    probs = torch.softmax(logits, dim=-1)
    one_hot = F.one_hot(_squeeze_labels(labels), n_classes).to(probs.dtype)
    if weights is not None:
        w = weights.to(probs.dtype)[..., None]
        probs = probs * w
        one_hot = one_hot * w
    return one_hot, probs


def jacard_coef(labels, logits, smooth: float = 100.0, weights=None):
    one_hot, probs = _soft_one_hot(labels, logits, weights)
    intersection = (one_hot * probs).abs().sum(dim=(1, 2))
    union_sum = (one_hot + probs).abs().sum(dim=(1, 2))
    jac = (intersection + smooth) / (union_sum - intersection + smooth)
    # per class; a page of padding only would give the degenerate 1
    return _valid_page_mean(jac, page_validity(weights))


def jacard_coef_loss(labels, logits, weights=None):
    return (-torch.log(jacard_coef(labels, logits, weights=weights))).mean()


def dice_coef(labels, logits, smooth: float = 100.0, weights=None):
    one_hot, probs = _soft_one_hot(labels, logits, weights)
    intersection = (one_hot * probs).abs().sum(dim=(1, 2))
    union_sum = (one_hot + probs).abs().sum(dim=(1, 2))
    dice = (2.0 * intersection + smooth) / (union_sum + smooth)
    return _valid_page_mean(dice, page_validity(weights))


def dice_coef_loss(labels, logits, weights=None):
    return (-torch.log(dice_coef(labels, logits, weights=weights))).mean()


def categorical_hinge(labels, logits, weights=None):
    n_classes = logits.shape[-1]
    one_hot = F.one_hot(_squeeze_labels(labels), n_classes).to(logits.dtype)
    pos = (one_hot * logits).sum(dim=-1)
    neg = ((1.0 - one_hot) * logits).amax(dim=-1)
    return _wmean((neg - pos + 1.0).clamp_min(0.0), weights)


def dice_and_categorical(labels, logits, alpha: float = 1.0, weights=None):
    if not 0 <= alpha <= 1:
        raise ValueError(f"alpha must lie in [0, 1], got {alpha}")
    return (
        alpha * dice_coef_loss(labels, logits, weights=weights)
        + (1 - alpha) * loss(labels, logits, weights=weights)
    ) / 2


def categorical_focal_loss(labels, logits, gamma: float = 2.0, alpha: float = 0.25, weights=None):
    # the reference's formula, applied to the clipped raw logits
    n_classes = logits.shape[-1]
    one_hot = F.one_hot(_squeeze_labels(labels), n_classes).to(logits.dtype)
    y_pred = logits.clamp(EPSILON, 1.0 - EPSILON)
    focal = -one_hot * (alpha * torch.pow(1.0 - y_pred, gamma) * torch.log(y_pred))
    if weights is not None:
        # normalized by the valid elements only
        w = weights.to(focal.dtype)[..., None]
        return (focal * w).sum() / (w.sum() * n_classes).clamp_min(1.0) * 100.0
    return focal.mean() * 100.0


class Loss(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    JACCARD_LOSS = "jaccard"
    DICE_LOSS = "dice"
    CATEGORICAL_HINGE = "categorical_hinge"
    CATEGORCAL_FOCAL = "categorical_focal"
    DICE_AND_CROSSENTROPY = "dice_and_crossentropy"

    def __call__(self):
        return {
            Loss.CATEGORICAL_CROSSENTROPY: loss,
            Loss.JACCARD_LOSS: jacard_coef_loss,
            Loss.DICE_LOSS: dice_coef_loss,
            Loss.CATEGORICAL_HINGE: categorical_hinge,
            Loss.CATEGORCAL_FOCAL: categorical_focal_loss,
            Loss.DICE_AND_CROSSENTROPY: dice_and_categorical,
        }[self]


class Monitor(enum.Enum):
    VAL_LOSS = "val_loss"
    VAL_ACCURACY = "val_accuracy"
    ACCURACY = "accuracy"
    LOSS = "loss"
    DICE_COEF = "dice_coef"
    JACRAD_COEF = "jacard_coef"
    FGPA = "fgpa"

    @property
    def mode(self) -> str:
        """'min' if lower is better."""
        return "min" if "loss" in self.value else "max"

    @property
    def is_validation(self) -> bool:
        return self.value.startswith("val_")
