"""The plain reference of the predict paths, from full-resolution pages to
the color / overlay / inverted trio.

Stages, each written from its definition:

* box decimation by ``f`` with round-half-up of the mean (``(sum + f*f/2)
  // (f*f)``), the last rows and columns that fill no box dropped;
* the ink mask: the binary (< 128 is ink) sampled at the nearest
  center-aligned grid of the normalized page (``floor((i + 0.5) * in / out
  - 0.5 + 0.5)``, clipped);
* the antialiased bicubic resample (Keys a = -0.5) of the decimated page to
  the normalized shape, then the model's preprocess: ``1 - x / 255``
  (gray) or, for the ``torch`` mode, ``255 - x`` repeated to 3 channels,
  ``/ 255``, minus the ImageNet mean, over its std; zero padding to the
  stride's multiple after it;
* the float32 forward of ``models.py`` (TF32 off), the argmax over
  classes (first maximum);
* the majority vote of each 4-connected ink component (ties to the lowest
  class);
* the trio: ``color = palette[class]``, ``overlay`` = color off the ink,
  ``inverted`` = color on the ink, black elsewhere.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import models

_TORCH_MEAN = (0.485, 0.456, 0.406)
_TORCH_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def float32_exact():
    """Float32 convolutions and matmuls without TF32, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def normalized_shape(page_shape: Sequence[int], scale: float) -> Tuple[int, int]:
    return int(np.round(page_shape[0] * scale)), int(np.round(page_shape[1] * scale))


def nearest_index(out_dim: int, in_dim: int) -> np.ndarray:
    coords = (np.arange(out_dim) + 0.5) * (in_dim / out_dim) - 0.5
    return np.clip(np.floor(coords + 0.5).astype(np.int64), 0, in_dim - 1)


def decimate(pages: torch.Tensor, f: int) -> torch.Tensor:
    n, h, w = pages.shape
    oh, ow = h // f, w // f
    s = pages[:, :oh * f, :ow * f].to(torch.int32).view(n, oh, f, ow, f).sum(dim=(2, 4))
    return ((s + f * f // 2) // (f * f)).to(torch.uint8)


def ink_mask(binaries: np.ndarray, out_shape: Sequence[int]) -> np.ndarray:
    """(n, H, W) binaries -> (n, oh, ow) bool ink at the nearest grid."""
    rows = nearest_index(out_shape[0], binaries.shape[1])
    cols = nearest_index(out_shape[1], binaries.shape[2])
    return binaries[:, rows][:, :, cols] < 128


def model_input(dec: torch.Tensor, out_shape, pad_shape, mode: str) -> torch.Tensor:
    img = F.interpolate(dec.to(torch.float32)[:, None], size=tuple(out_shape), mode="bicubic",
                        antialias=True, align_corners=False)
    if mode == "gray":
        x = 1.0 - img / 255.0
    elif mode == "torch":
        mean = img.new_tensor(_TORCH_MEAN)[None, :, None, None]
        std = img.new_tensor(_TORCH_STD)[None, :, None, None]
        x = ((255.0 - img).expand(-1, 3, -1, -1) / 255.0 - mean) / std
    else:
        raise ValueError(f"preprocess mode {mode!r} has no reference")
    return F.pad(x, (0, pad_shape[1] - out_shape[1], 0, pad_shape[0] - out_shape[0]))


def vote(pred: np.ndarray, ink: np.ndarray, n_classes: int) -> np.ndarray:
    """Each 4-connected ink component of one page set to its majority class."""
    from scipy import ndimage

    labels, n = ndimage.label(ink)
    counts = np.bincount(labels[ink].astype(np.int64) * n_classes + pred[ink],
                         minlength=(n + 1) * n_classes).reshape(n + 1, n_classes)
    out = pred.copy()
    out[ink] = counts.argmax(axis=1)[labels[ink]]
    return out


def trio(classes: np.ndarray, ink: np.ndarray, palette: np.ndarray):
    color = palette[classes]
    ink3 = ink[..., None]
    return color, np.where(ink3, 0, color).astype(np.uint8), np.where(ink3, color, 0).astype(np.uint8)


class Truth(NamedTuple):
    """The reference's answer for one page: its voted classes, the float32
    logits (C, h, w) and their std, and the ink."""

    classes: np.ndarray
    logits: np.ndarray
    sigma: float
    ink: np.ndarray


class Predict:
    """The reference of one model on one page geometry."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], device,
                 cast: Optional[Callable] = None, block: int = 8):
        self.cfg, self.params, self.device, self.cast, self.block = cfg, params, device, cast, block
        self.forward = models.forward_of(cfg["architecture"])
        self.out_shape = normalized_shape(cfg["page_shape"], cfg["scale"])
        stride = cfg["stride_factor"]
        self.pad_shape = (round_up(self.out_shape[0], stride), round_up(self.out_shape[1], stride))
        self.palette = np.asarray(cfg["palette"], np.uint8)

    def logits(self, pages: np.ndarray) -> torch.Tensor:
        dec = decimate(torch.as_tensor(pages).to(self.device), self.cfg["host_decimate"])
        x = model_input(dec, self.out_shape, self.pad_shape, self.cfg["preprocess"])
        with torch.no_grad(), float32_exact():
            return self.forward(self.params, x, cast=self.cast)

    def truths(self, pages: np.ndarray, binaries: np.ndarray):
        h, w = self.out_shape
        ink = ink_mask(binaries, self.out_shape)
        out = []
        for start in range(0, len(pages), self.block):
            logits = self.logits(pages[start:start + self.block])[:, :, :h, :w].float().cpu().numpy()
            for i, lg in enumerate(logits):
                k = ink[start + i]
                classes = vote(lg.argmax(axis=0).astype(np.uint8), k, int(self.cfg["n_classes"]))
                out.append(Truth(classes, lg, float(lg.std()), k))
        return out

    def trios(self, pages: np.ndarray, binaries: np.ndarray):
        return [trio(t.classes, t.ink, self.palette) for t in self.truths(pages, binaries)]


def classes_of(color: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """The class of each pixel of a color image, -1 where no palette color."""
    out = np.full(color.shape[:2], -1, np.int64)
    for c, rgb in enumerate(palette):
        out[(color == rgb).all(axis=-1)] = c
    return out


def decisive(truth: Truth, tau: float) -> np.ndarray:
    """Where the reference's answer does not hang on rounding: a pixel whose
    two best logits lie more than ``tau`` std apart; an ink pixel whose component's vote would stand if every pixel of it within
    ``tau`` changed its class (best count - second count > 2 x those
    pixels)."""
    from scipy import ndimage

    top2 = np.sort(truth.logits, axis=0)[-2:]
    sure = (top2[1] - top2[0]) > tau * max(truth.sigma, 1e-12)
    labels, n = ndimage.label(truth.ink)
    ink = truth.ink
    n_classes = truth.logits.shape[0]
    pred = truth.logits.argmax(axis=0)
    counts = np.bincount(labels[ink] * n_classes + pred[ink],
                         minlength=(n + 1) * n_classes).reshape(n + 1, n_classes)
    unsure = np.bincount(labels[ink & ~sure], minlength=n + 1)
    best2 = np.sort(counts, axis=1)[:, -2:]
    stands = (best2[:, 1] - best2[:, 0]) > 2 * unsure
    out = sure.copy()
    out[ink] = stands[labels[ink]]
    return out


def page_mismatch(got: Sequence[np.ndarray], truth: Truth, palette: np.ndarray,
                  tau: float, sure: Optional[np.ndarray] = None) -> float:
    """Share of the page's pixels whose answered class differs from the
    reference's where the reference is decisive (``decisive``), or whose
    color is no class, or whose overlay / inverted disagree with the color
    and the reference's ink; 1.0 for a misshapen image.  ``got`` is the
    trio; ``sure`` is ``decisive(truth, tau)`` where the caller has it."""
    color, overlay, inverted = (np.asarray(g) for g in got)
    if color.shape != truth.classes.shape + (3,) or color.dtype != np.uint8:
        return 1.0
    if overlay.shape != color.shape or inverted.shape != color.shape:
        return 1.0
    answered = classes_of(color, palette)
    if sure is None:
        sure = decisive(truth, tau)
    wrong = (answered < 0) | ((answered != truth.classes) & sure)
    ink3 = truth.ink[..., None]
    wrong |= (overlay != np.where(ink3, 0, color)).any(-1)
    wrong |= (inverted != np.where(ink3, color, 0)).any(-1)
    return float(wrong.mean())


def check_mismatch(ctx, pairs, palette: np.ndarray) -> None:
    """The cell's check: the mean over its (answer, Truth) pairs of
    ``page_mismatch`` at the cell's ``decisive_margin``."""
    tau = float(ctx.cell.workload["decisive_margin"])
    sure = {}  # one mask per reference page: many answers share one
    for _, truth in pairs:
        if id(truth) not in sure:
            sure[id(truth)] = decisive(truth, tau)
    ctx.check("decisive_mismatch", float(np.mean(
        [page_mismatch(g, t, palette, tau, sure[id(t)]) for g, t in pairs])) if pairs else 1.0)
