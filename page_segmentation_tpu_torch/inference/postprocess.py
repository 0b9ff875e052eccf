"""Label-map cleanup after the forward.

Counterpart of ``page_segmentation_tpu/inference/postprocess.py``:

* :func:`vote_connected_component_class`: the majority class of each
  4-connected component of the page's binary, on the port's native
  union-find vote (``native/ps_native.cpp`` ``ps_cc_vote``);
* :func:`add_bounding_boxes`: each per-class component replaced by its
  filled bounding box, classes in ascending order (later ones overwrite);
* the registry: :data:`POSTPROCESSORS`, :func:`find_postprocessor`,
  :func:`postprocess_help`;
* :func:`cc_vote_on_device`: the same vote on torch tensors.  A CUDA tensor
  is labeled by the hand-written CUDA labeler (``csrc/cc_label.cu``) and
  voted by the torch histogram of ``ops/cuda_cc.py``; a CPU tensor takes
  the plain version, the JAX package's min-propagation and pointer-jump
  loop.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.dataset import SingleData
from ..device import resolve_device
from ..ops.cc import CC_STAT_HEIGHT, CC_STAT_LEFT, CC_STAT_TOP, CC_STAT_WIDTH, connected_components_with_stats


def vote_connected_component_class(pred: np.ndarray, data: SingleData) -> np.ndarray:
    """``pred`` with every 4-connected ink component of ``data.binary`` set
    to its majority class (ties to the lowest class); dtype kept."""
    from .. import native

    pred = np.asarray(pred)
    n_classes = int(pred.max()) + 1 if pred.size else 1
    return native.cc_vote(np.asarray(data.binary), pred, n_classes).astype(pred.dtype)


def add_bounding_boxes(pred: np.ndarray, data: SingleData) -> np.ndarray:
    pred = np.asarray(pred)
    newpred = np.zeros_like(pred)
    for c in np.unique(pred):
        num_labels, _, stats, _ = connected_components_with_stats(pred == c, connectivity=4)
        for i in range(1, num_labels):
            left, top = stats[i, CC_STAT_LEFT], stats[i, CC_STAT_TOP]
            w, h = stats[i, CC_STAT_WIDTH], stats[i, CC_STAT_HEIGHT]
            newpred[top : top + h, left : left + w] = c
    return newpred


def find_postprocessor(key: str) -> Callable[[np.ndarray, SingleData], np.ndarray]:
    return POSTPROCESSORS[key.lower().replace("_", "").replace("-", "")]


def postprocess_help() -> str:
    return (
        "Postprocessors available:\n"
        "cc_majority:    classify all pixels of each connected component as most frequent class.\n"
        "bounding_boxes: replace each connected component in the prediction with its bounding box.\n"
    )


POSTPROCESSORS = {
    "ccmajority": vote_connected_component_class,
    "ccvote": vote_connected_component_class,
    "voteconnectedcomponents": vote_connected_component_class,
    "votecomponents": vote_connected_component_class,
    "boundingboxes": add_bounding_boxes,
    "bbox": add_bounding_boxes,
}


# ------------------------------------------------------------------- device
def _propagated_min_labels(ink: torch.Tensor, max_iters: int) -> torch.Tensor:
    """The JAX package's labeling loop on one (H, W) page: each sweep takes
    the minimum over the 4 neighbours within ink, then jumps each pixel to
    the label held at its label's pixel; up to ``max_iters`` sweeps or a
    fixed point.  Ink gets 1 + the min flat index of its component once
    converged; background gets ``h * w + 2``."""
    h, w = ink.shape
    big = h * w + 2
    flat_idx = torch.arange(1, h * w + 1, dtype=torch.int32, device=ink.device).view(h, w)
    labels = torch.where(ink, flat_idx, big)
    for _ in range(max_iters):
        pad = torch.nn.functional.pad(labels[None, None], (1, 1, 1, 1), value=big)[0, 0]
        neighbours = torch.minimum(torch.minimum(pad[:-2, 1:-1], pad[2:, 1:-1]),
                                   torch.minimum(pad[1:-1, :-2], pad[1:-1, 2:]))
        new = torch.where(ink, torch.minimum(labels, neighbours), big)
        flat = new.flatten()
        root = torch.where(flat < big, flat[(flat - 1).clamp(0, h * w - 1).long()], big)
        new = torch.minimum(new, root.view(h, w))
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def cc_vote_on_device(pred, binary, n_classes: int, max_iters: int = 256, device="cuda"):
    """cc-majority vote of one (H, W) class map over the 4-connected
    components of ``binary != 0``, on ``device``; returns a tensor of
    ``pred``'s dtype there.  On the card the CUDA labeler gives exact labels
    at any size (``max_iters`` bounds only the plain version's sweeps)."""
    from ..ops.cuda_cc import _label_cuda, _vote_from_labels

    dev = resolve_device(device)
    pred = torch.as_tensor(pred, device=dev)
    ink = torch.as_tensor(binary, device=dev) != 0
    if pred.dim() != 2 or pred.shape != ink.shape:
        raise ValueError(f"pred {tuple(pred.shape)} and binary {tuple(ink.shape)} must be one (H, W) page")
    if dev.type == "cuda":
        labels = _label_cuda(ink.contiguous()[None])
    else:
        labels = torch.where(ink, _propagated_min_labels(ink, max_iters), 0)[None]
    return _vote_from_labels(pred[None], ink[None], labels, n_classes)[0]
