"""page_segmentation_tpu_torch — the PyTorch/CUDA port of page_segmentation_tpu.

The throughput predict path (host decimate -> device resample/normalize ->
FCNSkip -> argmax -> cc-majority vote -> packed download -> host trio) runs
on an NVIDIA Hopper card, with the connected-component labeling of the
device vote in a hand-written CUDA kernel (``csrc/cc_label.cu``).  Module
names mirror the JAX package so each counterpart is easy to find.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; a missing card raises rather than falling back.
"""

__version__ = "0.1.0"

from .core.colors import ColorMap, DEFAULT_IMAGE_MAP  # noqa: F401
from .device import resolve_device  # noqa: F401


def __getattr__(name):
    # lazy exports keep `import page_segmentation_tpu_torch` light
    lazy = {
        "FCN": ("page_segmentation_tpu_torch.models.fcn", "FCN"),
        "FCNSkip": ("page_segmentation_tpu_torch.models.fcn", "FCNSkip"),
        "params_from_jax": ("page_segmentation_tpu_torch.models.bridge", "params_from_jax"),
        "init_params_numpy": ("page_segmentation_tpu_torch.models.bridge", "init_params_numpy"),
        "make_fused_predict": ("page_segmentation_tpu_torch.inference.pipeline", "make_fused_predict"),
        "ThroughputPredictor": ("page_segmentation_tpu_torch.inference.pipeline", "ThroughputPredictor"),
        "cc_min_label": ("page_segmentation_tpu_torch.ops.cuda_cc", "cc_min_label"),
        "cc_min_label_batch": ("page_segmentation_tpu_torch.ops.cuda_cc", "cc_min_label_batch"),
        "cc_vote_batch": ("page_segmentation_tpu_torch.ops.cuda_cc", "cc_vote_batch"),
        "native": ("page_segmentation_tpu_torch.native", None),
    }
    if name in lazy:
        import importlib

        module, attr = lazy[name]
        mod = importlib.import_module(module)
        return mod if attr is None else getattr(mod, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
