"""The plain reference of one training step: loss, gradients, clipping and
Adam, in float32 with TF32 off, written from the definitions.

* Input: the trainer's compact batch (uint8 pixels, uint8 class mask and
  each page's valid rows and columns); the gray preprocess ``x / 255``, 0
  on the padding, the padding weighing 0 in the loss.
* Forward: ``reference/models.py`` (FCNSkip) or ``reference/unet.py``
  (U-Net, with flax's dropout).
* Loss: the mean sparse softmax cross-entropy over the valid pixels,
  ``sum(w * ce) / max(sum(w), 1)``, as ``train/metrics.py`` ``loss``
  defines it.
* Gradients: autograd.
* Keras ``clipnorm``: each gradient tensor scaled to L2 norm ``c`` where its
  own norm exceeds it (``g * c / (norm + 1e-12)``).
* Adam (optax's ``scale_by_adam`` then ``-learning_rate``): ``mu = (1 - b1)
  g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``count + 1``, bias corrections
  ``1 - b^count``, ``mu_hat / (sqrt(nu_hat) + 1e-8)``.
* Dropout: flax ``nn.Dropout(0.5)``.  The layer's key is flax's
  ``make_rng("dropout")`` in the module ``Dropout_<i>``: the step's key with
  the first 4 bytes of the SHA-1 of ``"Dropout_<i>"`` and the byte 1 folded
  in (``fold_in``, a threefry-2x32 hash of the counter (0, data)).  Each
  element keeps where the float of its bits, drawn by threefry-2x32 (20
  rounds) of its NHWC flat index as a 64-bit counter, the two output words
  XORed, ``((bits >> 9) | 0x3F800000) - 1`` as float32, is below the keep
  probability; kept elements are divided by it.

The scale of the benchmark's check: the same gradients with TF32 allowed,
the rounding the configuration states, whose distance from the float32
gradients the program's is measured against (``gradient_check``).  The
weights' change of a step against this Adam from the same weights and
state (``update_error``).

Nothing here imports the program, JAX or a kernel: threefry and SHA-1 are
written out below.
"""
from __future__ import annotations

import contextlib
import struct
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from . import models, unet

Key = Tuple[int, int]
M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
DROPOUT_RATE = 0.5
# the step this file defines: Adam at the ``train`` command's learning rate,
# after Keras clipnorm at 1.0, in float32
OPTIMIZER, LR, CLIPNORM, DTYPE = "adam", 1e-4, 1.0, "float32"


@contextlib.contextmanager
def precision(tf32: bool = False):
    """Float32 convolutions and matmuls, with TF32 on or off, restored after."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------------------ keys
def threefry2x32(key: Key, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """threefry-2x32, 20 rounds, of the counter words (x0, x1): int64
    tensors holding uint32 values."""
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) & M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def fold_in(key: Key, data: int) -> Key:
    y0, y1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([data & M32], dtype=torch.int64))
    return int(y0[0]), int(y1[0])


def sha1(message: bytes) -> bytes:
    """SHA-1 (FIPS 180-4)."""
    h = [0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476, 0xC3D2E1F0]
    padded = message + b"\x80" + b"\x00" * ((55 - len(message)) % 64)
    padded += struct.pack(">Q", 8 * len(message))

    def rotl(v, n):
        return ((v << n) | (v >> (32 - n))) & M32

    for block in range(0, len(padded), 64):
        w = list(struct.unpack(">16I", padded[block:block + 64]))
        for t in range(16, 80):
            w.append(rotl(w[t - 3] ^ w[t - 8] ^ w[t - 14] ^ w[t - 16], 1))
        a, b, c, d, e = h
        for t in range(80):
            if t < 20:
                f, k = (b & c) | (~b & d), 0x5A827999
            elif t < 40:
                f, k = b ^ c ^ d, 0x6ED9EBA1
            elif t < 60:
                f, k = (b & c) | (b & d) | (c & d), 0x8F1BBCDC
            else:
                f, k = b ^ c ^ d, 0xCA62C1D6
            a, b, c, d, e = (rotl(a, 5) + f + e + k + w[t]) & M32, a, rotl(b, 30), c, d
        h = [(x + y) & M32 for x, y in zip(h, (a, b, c, d, e))]
    return struct.pack(">5I", *h)


def layer_key(step_key: Key, layer: int) -> Key:
    """flax's ``make_rng("dropout")`` in ``Dropout_<layer>``."""
    data = f"Dropout_{layer}".encode() + bytes([1])
    return fold_in(step_key, int.from_bytes(sha1(data)[:4], "big"))


def keep_mask(key: Key, shape_nchw: Sequence[int], rate: float, device) -> torch.Tensor:
    """The dropout's keep mask of an NCHW tensor, drawn over the NHWC index."""
    n, c, h, w = (int(s) for s in shape_nchw)
    index = torch.arange(n * h * w * c, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, index >> 32, index & M32)
    bits = (y0 ^ y1).to(torch.int64)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    keep_prob = torch.tensor(1.0 - rate, dtype=torch.float32).item()
    return (floats < keep_prob).reshape(n, h, w, c).permute(0, 3, 1, 2)


def dropout(x: torch.Tensor, key: Key, rate: float = DROPOUT_RATE) -> torch.Tensor:
    keep = keep_mask(key, x.shape, rate, x.device)
    return torch.where(keep, x / torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device),
                       torch.zeros((), dtype=x.dtype, device=x.device))


# ------------------------------------------------------------- the models
def _fcnskip_forward(p, x, drop=None):
    return models.fcnskip_forward(p, x)


ARCHITECTURES: Dict[str, Tuple[Callable, Callable]] = {
    "fcn_skip": (models.fcnskip_leaves, _fcnskip_forward),
    "unet": (unet.unet_leaves, unet.unet_forward),
}


def leaves_of(architecture: str, n_classes: int):
    return ARCHITECTURES[architecture][0](n_classes)


def forward_of(architecture: str) -> Callable:
    """fn(params, x, drop=None) -> NCHW logits."""
    return ARCHITECTURES[architecture][1]


# ------------------------------------------------------------------ a step
def model_input(batch: Dict[str, torch.Tensor]):
    """(x NCHW float32, labels (N, H, W) int64, weights (N, H, W) float32)
    of a compact batch."""
    image = batch["image"]
    n, h, w = image.shape[:3]
    dims = batch["dims"].to(image.device).to(torch.int64)
    rows = torch.arange(h, device=image.device).view(1, h, 1)
    cols = torch.arange(w, device=image.device).view(1, 1, w)
    weights = ((rows < dims[:, 0, None, None]) & (cols < dims[:, 1, None, None])).to(torch.float32)
    x = (image.to(torch.float32) / 255.0) * weights[..., None]
    return x.permute(0, 3, 1, 2).contiguous(), batch["mask"].to(torch.int64), weights


def loss_of(logits: torch.Tensor, labels: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    ce = -torch.log_softmax(logits.float(), dim=1).gather(1, labels[:, None])[:, 0]
    return (ce * weights).sum() / weights.sum().clamp_min(1.0)


def loss_and_grads(architecture: str, params: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], step_key: Optional[Key], tf32: bool = False):
    """(loss, {name: gradient}) of one batch in float32, TF32 off (on with
    ``tf32``: the yardstick's scale of TF32 rounding, not its truth); with a
    ``step_key`` the model's dropout draws its masks from it."""
    x, labels, weights = model_input(batch)
    leaves = {k: v.detach().to(torch.float32).requires_grad_(True) for k, v in params.items()}
    drop = None if step_key is None else (lambda h, i: dropout(h, layer_key(step_key, i)))
    with precision(tf32):
        logits = forward_of(architecture)(leaves, x, drop)
        loss = loss_of(logits, labels, weights)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), {k: g.detach() for k, g in zip(leaves, grads)}


def clip_norm(grads: Dict[str, torch.Tensor], max_norm: float = 1.0) -> Dict[str, torch.Tensor]:
    out = {}
    for k, g in grads.items():
        norm = torch.sqrt((g * g).sum())
        out[k] = torch.where(norm > max_norm, g * (max_norm / (norm + 1e-12)), g)
    return out


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    return {"count": 0, "mu": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v, dtype=torch.float32) for k, v in params.items()}}


def adam_step(params, grads, state, lr: float = LR):
    """(new params, new state): optax's Adam and then ``-lr`` times its output."""
    count = state["count"] + 1
    c1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** count
    c2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** count
    mu, nu, new = {}, {}, {}
    for k, g in grads.items():
        mu[k] = (1 - B1) * g + B1 * state["mu"][k]
        nu[k] = (1 - B2) * (g * g) + B2 * state["nu"][k]
        direction = (mu[k] / c1.to(g.device)) / (torch.sqrt(nu[k] / c2.to(g.device)) + ADAM_EPS)
        new[k] = params[k] + (-lr) * direction
    return new, {"count": count, "mu": mu, "nu": nu}


def train_step(architecture: str, params, batch, step_key: Optional[Key], state,
               lr: float = LR, clipnorm: float = CLIPNORM):
    """(loss, clipped gradients, new params, new Adam state) of one step."""
    loss, grads = loss_and_grads(architecture, params, batch, step_key)
    clipped = clip_norm(grads, clipnorm)
    with torch.no_grad():
        new_params, new_state = adam_step(params, clipped, state, lr)
    return loss, clipped, new_params, new_state


def adam_input(mu_before: torch.Tensor, mu_after: torch.Tensor) -> torch.Tensor:
    """The gradient an Adam step took, from its first moment before and
    after: ``(mu_after - b1 mu_before) / (1 - b1)``, in float64."""
    return (mu_after.double() - B1 * mu_before.double()) / (1 - B1)


def relative_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want||, in float64."""
    got, want = got.double(), want.double()
    return float(torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want).clamp_min(1e-300))


def gradient_error(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]) -> float:
    """The relative L2 error of a whole gradient, its tensors as one vector."""
    return relative_error(torch.cat([got[k].flatten() for k in want]),
                          torch.cat([want[k].flatten() for k in want]))


# the float32 reference's own rounding over a network: the scale's floor
# where TF32 does not exist (the CPU), ~16 ulp of float32
FLOAT32_SCALE = 1e-6


def gradient_check(got, architecture: str, params, batch, step_key: Optional[Key],
                   clipnorm: float = CLIPNORM):
    """(the whole gradient's relative error of ``got`` against the clipped
    float32 reference, the same of the reference in TF32, the reference's
    clipped gradients, its loss).  Their ratio is the check: a gradient that
    sums millions of cancelling terms amplifies every rounding alike, so the
    error alone swings from step to step; over TF32's own it does not."""
    loss, grads = loss_and_grads(architecture, params, batch, step_key)
    _, grads_tf32 = loss_and_grads(architecture, params, batch, step_key, tf32=True)
    want = clip_norm(grads, clipnorm)
    return (gradient_error(got, want), gradient_error(clip_norm(grads_tf32, clipnorm), want), want,
            loss)


def update_error(before, after, grads, state, lr: float = LR) -> float:
    """The largest over the tensors of the relative L2 error of the weights'
    change ``after - before`` against Adam's change from ``before`` with
    ``grads`` and the Adam state ``state`` (``adam_step``), in float64.
    Weights left unchanged read 1."""
    want, _ = adam_step(before, {k: g.to(torch.float32) for k, g in grads.items()}, state, lr)
    return max(relative_error(after[k].double() - before[k].double(),
                              want[k].double() - before[k].double()) for k in want)
