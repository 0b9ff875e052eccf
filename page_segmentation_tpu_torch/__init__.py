"""page_segmentation_tpu_torch — the PyTorch/CUDA port of page_segmentation_tpu.

Two predict paths run on an NVIDIA Hopper card:

* the throughput path (host decimate -> device resample/normalize ->
  FCNSkip -> argmax -> cc-majority vote -> packed download -> host trio),
  ``ThroughputPredictor``;
* the per-page library path (``DatasetLoader`` -> ``PixelClassifier`` ->
  ``Predictor``, with the cc-majority vote fused into the batched dispatch).

Both label connected components for the device vote with a hand-written
CUDA kernel (``csrc/cc_label.cu``).  Users reach them through the raw-corpus
streamer (``RawCorpusPredictor``), the batching HTTP service
(``BatchingService``, ``PredictionServer``) and the command line
(``python -m page_segmentation_tpu_torch.cli``: ``predict``, ``serve``,
``evaluate``, ``compute-image-normalizations``, ``create-dataset-file``,
``train``, and the ground-truth and segmentation tools ``gen-masks`` and
``page-segmentation``).  The training path (dataset JSON -> ``DatasetLoader`` ->
``Trainer`` -> checkpoints with the optimizer state, and the ``Network``
facade) trains FCNSkip with cuDNN's convolutions through autograd.
``tools/repro_download.py`` checks that downloads come back whole under
concurrent uploads, with the elementwise kernel ``csrc/add_one.cu``.  Module names mirror the JAX package
so each counterpart is easy to find.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; a missing card raises rather than falling back.
"""

__version__ = "0.3.0"

from .core.colors import ColorMap, DEFAULT_IMAGE_MAP  # noqa: F401
from .device import resolve_device  # noqa: F401

_LAZY = {
    "FCN": ("page_segmentation_tpu_torch.models.fcn", "FCN"),
    "FCNSkip": ("page_segmentation_tpu_torch.models.fcn", "FCNSkip"),
    "Architecture": ("page_segmentation_tpu_torch.models.registry", "Architecture"),
    "params_from_jax": ("page_segmentation_tpu_torch.models.bridge", "params_from_jax"),
    "init_params_numpy": ("page_segmentation_tpu_torch.models.bridge", "init_params_numpy"),
    "load_checkpoint": ("page_segmentation_tpu_torch.train.checkpoint", "load_checkpoint"),
    "save_checkpoint": ("page_segmentation_tpu_torch.train.checkpoint", "save_checkpoint"),
    "SingleData": ("page_segmentation_tpu_torch.data.dataset", "SingleData"),
    "Dataset": ("page_segmentation_tpu_torch.data.dataset", "Dataset"),
    "DatasetLoader": ("page_segmentation_tpu_torch.data.loader", "DatasetLoader"),
    "PixelClassifier": ("page_segmentation_tpu_torch.inference.classifier", "PixelClassifier"),
    "Predictor": ("page_segmentation_tpu_torch.inference.predictor", "Predictor"),
    "PredictSettings": ("page_segmentation_tpu_torch.inference.predictor", "PredictSettings"),
    "make_fused_predict": ("page_segmentation_tpu_torch.inference.pipeline", "make_fused_predict"),
    "ThroughputPredictor": ("page_segmentation_tpu_torch.inference.pipeline", "ThroughputPredictor"),
    "RawCorpusPredictor": ("page_segmentation_tpu_torch.inference.corpus", "RawCorpusPredictor"),
    "RawPage": ("page_segmentation_tpu_torch.inference.corpus", "RawPage"),
    "BatchingService": ("page_segmentation_tpu_torch.inference.server", "BatchingService"),
    "PredictionServer": ("page_segmentation_tpu_torch.inference.server", "PredictionServer"),
    "cc_min_label": ("page_segmentation_tpu_torch.ops.cuda_cc", "cc_min_label"),
    "cc_min_label_batch": ("page_segmentation_tpu_torch.ops.cuda_cc", "cc_min_label_batch"),
    "cc_vote_batch": ("page_segmentation_tpu_torch.ops.cuda_cc", "cc_vote_batch"),
    "add_one": ("page_segmentation_tpu_torch.ops.cuda_add_one", "add_one"),
    "native": ("page_segmentation_tpu_torch.native", None),
    "Trainer": ("page_segmentation_tpu_torch.train.trainer", "Trainer"),
    "TrainSettings": ("page_segmentation_tpu_torch.train.trainer", "TrainSettings"),
    "AugmentationSettings": ("page_segmentation_tpu_torch.train.trainer", "AugmentationSettings"),
    "Network": ("page_segmentation_tpu_torch.network", "Network"),
    "Loss": ("page_segmentation_tpu_torch.train.metrics", "Loss"),
    "Monitor": ("page_segmentation_tpu_torch.train.metrics", "Monitor"),
    "Optimizers": ("page_segmentation_tpu_torch.models.registry", "Optimizers"),
    "find_postprocessor": ("page_segmentation_tpu_torch.inference.postprocess", "find_postprocessor"),
    "Masks": ("page_segmentation_tpu_torch.inference.output", "Masks"),
    "generate_output_masks": ("page_segmentation_tpu_torch.inference.output", "generate_output_masks"),
    "MaskGenerator": ("page_segmentation_tpu_torch.pagexml.mask_gen", "MaskGenerator"),
    "MaskSetting": ("page_segmentation_tpu_torch.pagexml.mask_gen", "MaskSetting"),
    "MaskType": ("page_segmentation_tpu_torch.pagexml.mask_gen", "MaskType"),
    "find_segments": ("page_segmentation_tpu_torch.segmentation.pc_segmentation", "find_segments"),
    "get_text_contours": ("page_segmentation_tpu_torch.segmentation.pc_segmentation", "get_text_contours"),
    "build_pagexml": ("page_segmentation_tpu_torch.pagexml.xml_gen", "build_pagexml"),
    "save_pagexml": ("page_segmentation_tpu_torch.pagexml.xml_gen", "save_pagexml"),
}


def __getattr__(name):
    # lazy exports keep `import page_segmentation_tpu_torch` light
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        mod = importlib.import_module(module)
        return mod if attr is None else getattr(mod, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
