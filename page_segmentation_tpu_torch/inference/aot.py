"""The predict program as a deployable artifact (``torch.export``).

Counterpart of ``page_segmentation_tpu/inference/aot.py``, which exports
with ``jax.export``.  ``export_classifier`` exports the classifier's
program: prepared uint8 pages ``(B, H, W)`` -> float32 -> normalization
(the RGB families repeat the gray channel and apply their device
preprocess) -> forward -> uint8 argmax ``(B, H, W)`` or float32 logits
``(B, H, W, n_classes)``, weights inside.  One ``torch.export`` program per
device in ``platforms`` ("cuda", "cpu"), since an exported program holds
its weights on one device.  Shapes are symbolic by default, ``(b, k·h,
k·w)`` with ``k`` the stride factor, so one program serves every page size;
with ``shapes`` there is one program per static ``(H, W)``, the batch still
symbolic.

Artifact (zip):
    manifest.json                 format, version, architecture, n_classes,
                                  output, platforms, stride_factor,
                                  symbolic, shapes, torch_version
    program.{device}.pt2          symbolic mode, one per device
    program_{H}x{W}.{device}.pt2  static mode, one per shape and device

Each program is ``torch.export.save``'s own file.  The format string is the
port's own: a ``jax.export`` artifact cannot be read here.
"""
from __future__ import annotations

import io
import json
import zipfile
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device

FORMAT = "page-segmentation-torch-aot"
VERSION = 1


class _Program(torch.nn.Module):
    """The deployable computation around the classifier's module."""

    def __init__(self, module, preprocess, rgb: bool, output: str):
        super().__init__()
        self.module = module
        self.preprocess = preprocess
        self.rgb = rgb
        self.output = output

    def forward(self, image_u8):
        x = image_u8.to(torch.float32)[..., None]
        if self.rgb:
            x = x.expand(-1, -1, -1, 3)
        logits = self.module.forward_nchw(self.preprocess(x).permute(0, 3, 1, 2))
        if self.output == "logits":
            return logits.float().permute(0, 2, 3, 1)
        return logits.argmax(dim=1).to(torch.uint8)


def _program_name(shape, device: str) -> str:
    stem = "program" if shape is None else f"program_{shape[0]}x{shape[1]}"
    return f"{stem}.{device}.pt2"


def export_classifier(classifier, path: str, *, output: str = "pred",
                      platforms: Sequence[str] = ("cuda", "cpu"),
                      shapes: Optional[Sequence[Tuple[int, int]]] = None) -> dict:
    """Export ``classifier``'s predict program (weights included) to the zip
    at ``path``; returns the manifest.  ``output``: "pred" (uint8 class map)
    or "logits" (float32).  ``shapes``: None for one symbolic-shape program,
    or static ``(H, W)`` multiples of the stride factor.  Each platform is
    a device the program is exported on ("cuda" needs a card)."""
    if output not in ("pred", "logits"):
        raise ValueError(f"output must be 'pred' or 'logits', got {output!r}")
    stride = classifier.architecture.stride_factor
    if shapes is not None:
        for height, width in shapes:
            if height % stride or width % stride:
                raise ValueError(
                    f"shape ({height}, {width}) is not a multiple of the "
                    f"{classifier.architecture.value} stride factor {stride}")
    devices = [resolve_device(p) for p in platforms]
    batch = torch.export.Dim("b", min=1)
    programs = {}
    for platform, device in zip(platforms, devices):
        module = classifier.architecture.model(
            classifier.n_classes, dtype=classifier.compute_dtype, s2d_stem=classifier.s2d_stem)
        module.load_state_dict(classifier.module.state_dict())
        program = _Program(module, classifier.architecture.device_preprocess(),
                           classifier.rgb, output).to(device).eval()
        if shapes is None:
            h, w = torch.export.Dim("h", min=1), torch.export.Dim("w", min=1)
            specs = [(None, (2, 2 * stride, 2 * stride), {0: batch, 1: stride * h, 2: stride * w})]
        else:
            specs = [(tuple(s), (2,) + tuple(s), {0: batch}) for s in shapes]
        for shape, example, dims in specs:
            x = torch.zeros(example, dtype=torch.uint8, device=device)
            with torch.no_grad():
                exported = torch.export.export(program, (x,), dynamic_shapes=({**dims},),
                                               strict=False)
            buf = io.BytesIO()
            torch.export.save(exported, buf)
            programs[_program_name(shape, platform)] = buf.getvalue()
    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "architecture": classifier.architecture.value,
        "n_classes": classifier.n_classes,
        "output": output,
        "platforms": list(platforms),
        "stride_factor": stride,
        "symbolic": shapes is None,
        "shapes": [list(s) for s in shapes] if shapes is not None else [],
        "torch_version": torch.__version__,
    }
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED) as zf:
        zf.writestr("manifest.json", json.dumps(manifest, indent=1))
        for name, blob in programs.items():
            zf.writestr(name, blob)
    return manifest


class AotClassifier:
    """An exported artifact, run on ``device`` without the model's code or
    checkpoint.

    ``predict(images)`` takes one prepared uint8 page ``(H, W)`` or a batch
    ``(B, H, W)``, pads each dim with zeros (background in the inverted page
    convention) to the next stride multiple, or in static mode to the
    smallest exported shape that fits, runs the program and crops back:
    the uint8 class map or float32 logits, as numpy."""

    def __init__(self, path: str, device="cuda"):
        self.device = resolve_device(device)
        with zipfile.ZipFile(path) as zf:
            names = zf.namelist()
            manifest = json.loads(zf.read("manifest.json")) if "manifest.json" in names else {}
            if manifest.get("format") != FORMAT:
                raise ValueError(f"{path} is not a {FORMAT} artifact")
            platform = self.device.type
            if platform not in manifest["platforms"]:
                raise ValueError(
                    f"{path} holds programs for {manifest['platforms']}, not {platform!r}")
            suffix = f".{platform}.pt2"
            self._programs = {
                name[: -len(suffix)]: torch.export.load(io.BytesIO(zf.read(name))).module()
                for name in names if name.endswith(suffix)}
        self.manifest = manifest
        self.stride = manifest["stride_factor"]
        self.n_classes = manifest["n_classes"]
        self.output = manifest["output"]

    def _program_for(self, height: int, width: int):
        if self.manifest["symbolic"]:
            return self._programs["program"], height, width
        fits = [(h, w) for h, w in self.manifest["shapes"] if h >= height and w >= width]
        if not fits:
            raise ValueError(f"no exported shape fits ({height}, {width}); "
                             f"have {self.manifest['shapes']}")
        h, w = min(fits, key=lambda s: s[0] * s[1])
        return self._programs[f"program_{h}x{w}"], h, w

    def predict(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, np.uint8)
        single = images.ndim == 2
        if single:
            images = images[None]
        height, width = images.shape[1:3]
        program, target_h, target_w = self._program_for(
            height + (-height % self.stride), width + (-width % self.stride))
        if (target_h, target_w) != (height, width):
            images = np.pad(images, ((0, 0), (0, target_h - height), (0, target_w - width)))
        with torch.inference_mode():
            out = program(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
        out = out.cpu().numpy()[:, :height, :width]
        return out[0] if single else out

    __call__ = predict
