"""Command-line interface of the port.

Counterpart of ``page_segmentation_tpu/cli/main.py``, with its flags,
defaults and error behaviour.  Ported subcommands:

    predict                        per-page (``--fast``: batched) or raw-corpus
                                   (``--pipeline``) prediction
    serve                          the batching HTTP service
    evaluate                       offline metrics of predictions against masks
    compute-image-normalizations   char heights per page

    train                          train from dataset JSON files
    create-dataset-file            a dataset directory -> dataset JSON splits

    gen-masks                      PageXML ground truth -> color mask PNGs
    page-segmentation              predictions -> region renders (+ PageXML)

``predict``, ``serve`` and ``train`` run on the card unless ``--device cpu``
is given; ``page-segmentation`` uses the card only with ``--morph_backend
device``.  ``export``, and the options of ``train`` that are not ported (``--distributed``, ``--n_devices``
> 1, ``--checkpoint_backend orbax``, ``--auto_resume``), keep their flags
and exit with an error naming the ROADMAP item that ports them.  A bare invocation is ``predict``; a user
error prints one line and returns 2.

    python -m page_segmentation_tpu_torch.cli predict --device cpu --load MODEL \\
        --images DIR --binary DIR --char_height 14 --output OUT
    python -m page_segmentation_tpu_torch.cli create-dataset-file --dataset_path DIR \\
        --character_height 50 --n_train 0.8 --n_test 0.2 --output_file data.json
    python -m page_segmentation_tpu_torch.cli train --device cpu --split_file data.json \\
        --output OUT --n_epoch 10
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Optional

logger = logging.getLogger("page_segmentation_tpu_torch")


# --------------------------------------------------------------------- utils
def _load_color_map(path: Optional[str]):
    from ..core.colors import DEFAULT_IMAGE_MAP, ColorMap

    return ColorMap.load(path) if path else DEFAULT_IMAGE_MAP


def _expand(items):
    """The files named by ``items``, glob patterns expanded (a pattern that
    matches nothing stays as it is)."""
    from ..core.image_io import glob_all

    return glob_all(items) if items else []


def _resolve_split_files(args, key: str):
    """Dataset JSON files of one split: the split's own flag, plus
    ``--split_file``, either a reference split file (its arrays hold dataset
    file paths) or a dataset JSON itself (it then counts for each split it
    fills)."""
    files = _expand(getattr(args, key, None))
    if getattr(args, "split_file", None):
        with open(args.split_file) as f:
            split = json.load(f)
        entries = split.get(key) or []
        if entries and isinstance(entries[0], str):
            files = files + entries
        elif entries:
            files = files + [args.split_file]
    return files


def _not_ported(item: str, what: str):
    def command(args) -> int:
        raise NotImplementedError(
            f"{args.command} ({what}) is not ported yet: ROADMAP queue 1 item {item}")

    return command


# ------------------------------------------------------------------- predict
def cmd_predict(args) -> int:
    from ..data.dataset import SingleData

    color_map = _load_color_map(args.color_map)

    binaries = sorted(os.listdir(args.binary)) if args.binary else []
    images = sorted(os.listdir(args.images))
    entries = []
    for name in images:
        binary_path = None
        if args.binary:
            base = os.path.splitext(name)[0]
            candidates = [b for b in binaries if os.path.splitext(b)[0].split(".")[0] == base.split(".")[0]]
            binary_path = os.path.join(args.binary, candidates[0] if candidates else name)
        line_height = args.char_height
        if args.norm:
            norm_file = os.path.join(args.norm, os.path.splitext(name)[0] + ".json")
            if os.path.exists(norm_file):
                with open(norm_file) as f:
                    line_height = json.load(f)["char_height"]
        if line_height is None and args.auto_norm:
            # the compute-image-normalizations estimate, per page
            from ..evaluation.image_ops import compute_char_height

            line_height = compute_char_height(binary_path or os.path.join(args.images, name), False)
            if line_height:
                logger.info(f"{name}: auto char_height {line_height}")
        if line_height is None:
            raise SystemExit(
                f"No line height for {name}: pass --char_height or --norm "
                f"(or --auto_norm to estimate it per page)")
        entries.append(SingleData(image_path=os.path.join(args.images, name),
                                  binary_path=binary_path, line_height_px=line_height))

    if args.pipeline:
        return _predict_pipeline(args, color_map, entries)

    from ..data.loader import DatasetLoader
    from ..inference.postprocess import find_postprocessor
    from ..inference.predictor import Predictor, PredictSettings

    loader = DatasetLoader(
        args.target_line_height, color_map, prediction=True, max_width=args.max_width,
        resize_backend=args.resize_backend, binarize=args.binarize,
    )
    dataset = loader.load_data(entries, lazy=args.streaming)
    post = [find_postprocessor(p) for p in (args.post_process or [])]
    settings = PredictSettings(
        network=args.load,
        output=args.output,
        high_res_output=args.high_res_output,
        color_map=color_map,
        n_classes=args.n_classes or color_map.n_classes,
        post_process=post or None,
        compute_dtype=args.dtype,
        s2d_stem=args.s2d_stem,
        int8=args.int8,
        n_devices=args.n_devices,
        spatial_threshold=args.spatial_threshold,
        band_rows=args.band_rows,
    )
    predictor = Predictor(settings, device=args.device)
    count = 0
    if args.fast:
        for _ in predictor.predict_dataset_fast(dataset, batch_size=args.batch_size, write_output=True):
            count += 1
    else:
        for prediction in predictor.predict(dataset):
            predictor.save_prediction(prediction)
            count += 1
    print(f"Predicted {count} pages -> {args.output}")
    return 0


def _predict_pipeline(args, color_map, entries) -> int:
    """``predict --pipeline``: the raw corpus through the throughput path,
    with the cc-majority vote on the host when it is asked for."""
    from ..inference.classifier import PixelClassifier
    from ..inference.corpus import RawCorpusPredictor, RawPage

    post_keys = [p.lower().replace("_", "").replace("-", "") for p in (args.post_process or [])]
    if post_keys and post_keys != ["ccmajority"]:
        raise SystemExit("--pipeline fuses only the cc_majority post-processor; drop --pipeline for others")
    if args.high_res_output:
        raise SystemExit("--pipeline outputs at the normalized scale; drop --pipeline for --high_res_output")
    if args.max_width:
        raise SystemExit("--pipeline sizes pages by line height alone; drop --pipeline for --max_width")
    classifier = PixelClassifier(
        n_classes=args.n_classes or color_map.n_classes,
        model_path=os.path.abspath(args.load),
        compute_dtype=args.dtype,
        s2d_stem=args.s2d_stem,
        device=args.device,
    )
    runner = RawCorpusPredictor(
        classifier,
        color_map.palette,
        target_line_height=args.target_line_height,
        batch_size=args.batch_size,
        cc_vote=bool(post_keys),
        int8=args.int8,
        compute_dtype=classifier.compute_dtype,
        binarize=args.binarize,
    )
    raw_pages = [RawPage(e.image_path, e.binary_path, e.line_height_px) for e in entries]
    count = sum(1 for _ in runner.run(raw_pages, output_dir=args.output))
    print(f"Predicted {count} pages -> {args.output}")
    return 0


# --------------------------------------------------------------------- train
_TRAIN_NOT_PORTED = (
    (lambda a: a.distributed, "--distributed (multi-host training)", "12"),
    (lambda a: a.n_devices and a.n_devices > 1, "--n_devices > 1 (data-parallel training)", "12"),
    (lambda a: a.checkpoint_backend == "orbax", "--checkpoint_backend orbax", "11"),
    (lambda a: a.auto_resume, "--auto_resume (Orbax checkpoints)", "11"),
)


def cmd_train(args) -> int:
    import math

    from ..data.loader import DatasetLoader
    from ..models.registry import Architecture, Optimizers
    from ..train.metrics import Loss, Monitor
    from ..train.trainer import AugmentationSettings, Trainer, TrainSettings

    for unported, what, item in _TRAIN_NOT_PORTED:
        if unported(args):
            raise NotImplementedError(f"{what} is not ported yet: ROADMAP queue 1 item {item}")
    color_map = _load_color_map(args.color_map)
    loader = DatasetLoader(args.target_line_height, color_map, max_width=args.max_width,
                           resize_backend=args.resize_backend)
    lazy = args.streaming
    train_data = loader.load_data_from_json(_resolve_split_files(args, "train"), "train", lazy=lazy)
    test_files = _resolve_split_files(args, "test")
    validation = loader.load_data_from_json(test_files, "test", lazy=lazy) if test_files else None
    eval_files = _resolve_split_files(args, "eval")
    evaluation = loader.load_data_from_json(eval_files, "eval", lazy=lazy) if eval_files else None

    n_classes = args.n_classes or color_map.n_classes
    if args.n_iter:
        n_epoch = max(1, math.ceil(args.n_iter / max(len(train_data), 1)))
    else:
        n_epoch = args.n_epoch

    settings = TrainSettings(
        n_epoch=n_epoch,
        n_classes=n_classes,
        l_rate=args.l_rate,
        train_data=train_data,
        validation_data=validation,
        evaluation_data=evaluation,
        display=args.display,
        output_dir=args.output,
        threads=args.threads,
        data_augmentation=args.data_augmentation,
        data_augmentation_settings=AugmentationSettings(),
        early_stopping_max_performance_drops=args.early_stopping_max_performance_drops,
        architecture=Architecture(args.architecture),
        loss=Loss(args.loss),
        monitor=Monitor(args.monitor),
        optimizer=Optimizers(args.optimizer),
        load=args.load,
        continue_training=args.continue_training,
        compute_baseline=args.compute_baseline,
        foreground_masks=args.foreground_masks,
        tensorboard=args.tensorboard,
        batch_size=args.batch_size,
        compute_dtype=args.dtype,
        seed=args.seed,
        device_augmentation=args.device_augmentation,
        remat=args.remat,
        grad_accum=args.grad_accum,
        skip_nonfinite=args.skip_nonfinite,
        lr_schedule=args.lr_schedule,
        lr_warmup_steps=args.lr_warmup_steps,
        lr_decay_steps=args.lr_decay_steps,
        lr_min_fraction=args.lr_min_fraction,
        balanced_sampling=args.balanced_sampling,
        balanced_sampling_strength=args.balanced_sampling_strength,
        class_weighting=args.class_weighting,
        pretrained_encoder=args.pretrained_encoder,
        export_h5=args.export_h5,
        device=args.device,
    )
    trainer = Trainer(settings)
    trainer.train()
    trainer.eval()
    print(f"Model written to {os.path.join(args.output, settings.model_name)}")
    return 0


# ------------------------------------------------------- create-dataset-file
def cmd_create_dataset_file(args) -> int:
    from ..data.dataset import list_dataset, single_split

    entries = []
    for root in args.dataset_path:
        entries += list_dataset(
            root,
            line_height_px=args.character_height,
            binary_dir_=args.binary_dir,
            images_dir_=args.images_dir,
            masks_dir_=args.masks_dir,
            masks_postfix=args.masks_postfix,
            normalizations_dir=args.normalizations_dir,
            verify_filenames=args.verify_filenames,
        )
    train, test, eval_ = single_split(args.n_train, args.n_test, args.n_eval, entries)
    with open(args.output_file, "w") as f:
        json.dump({"train": train, "test": test, "eval": eval_}, f, indent=2)
    print(f"Wrote {args.output_file}: {len(train)} train, {len(test)} test, {len(eval_)} eval")
    return 0


# ----------------------------------------- compute-image-normalizations
def cmd_compute_normalizations(args) -> int:
    import numpy as np

    from ..evaluation.image_ops import compute_char_height

    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.lower().endswith((".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")))
    heights = [(name, compute_char_height(os.path.join(args.input_dir, name), args.inverse))
               for name in files]
    valid = [h for _, h in heights if h]
    average = int(np.round(np.mean(valid))) if valid else None
    written = 0
    for name, ch in heights:
        value = average if args.average_all else ch
        if value is None:
            logger.warning(f"No char height for {name}; skipped")
            continue
        with open(os.path.join(args.output_dir, os.path.splitext(name)[0] + ".json"), "w") as f:
            json.dump({"char_height": int(value)}, f)
        written += 1
    print(f"Wrote {written} normalization files to {args.output_dir}")
    return 0


# --------------------------------------------------------------------- serve
def cmd_serve(args) -> int:
    """Long-lived prediction service with dynamic batching: concurrent POST
    /predict requests share device dispatches."""
    from ..inference.postprocess import find_postprocessor
    from ..inference.predictor import Predictor, PredictSettings
    from ..inference.server import BatchingService, PredictionServer

    color_map = _load_color_map(args.color_map)
    post = [find_postprocessor(p) for p in (args.post_process or [])]
    settings = PredictSettings(
        network=args.load,
        color_map=color_map,
        n_classes=args.n_classes or color_map.n_classes,
        post_process=post or None,
        compute_dtype=args.dtype,
        s2d_stem=args.s2d_stem,
        int8=args.int8,
    )
    service = BatchingService(
        Predictor(settings, device=args.device),
        color_map,
        target_line_height=args.target_line_height,
        default_char_height=args.char_height,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_width=args.max_width,
        max_queue=args.max_queue,
        resize_backend=args.resize_backend,
        prepare=args.prepare,
    )
    server = PredictionServer(service, host=args.host, port=args.port)
    logger.info("model %s ready; POST /predict on %s:%d", args.load, args.host, server.port)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


# ------------------------------------------------------------------ evaluate
def cmd_evaluate(args) -> int:
    import numpy as np

    from ..core.image_io import imread_bin
    from ..evaluation.image_ops import fgpa as fgpa_fn
    from ..evaluation.metrics import count_matches, f1_measures, total_accuracy

    color_map = _load_color_map(args.color_map)
    totals = {"correct": 0, "total": 0}
    per_label = {}
    fgpa_values = []
    for name in sorted(os.listdir(args.masks)):
        pred_path = os.path.join(args.predictions, name)
        if not os.path.exists(pred_path):
            logger.warning(f"Missing prediction for {name}")
            continue
        mask = color_map.imread_labels(os.path.join(args.masks, name))
        pred = color_map.imread_labels(pred_path)
        correct, total = total_accuracy(mask, pred)
        totals["correct"] += correct
        totals["total"] += total
        for label in range(color_map.n_classes):
            tp, fp, fn = count_matches(mask, pred, label)
            agg = per_label.setdefault(label, [0, 0, 0])
            agg[0] += tp
            agg[1] += fp
            agg[2] += fn
        if args.binary:
            binary = (imread_bin(os.path.join(args.binary, name)) < 128).astype(np.int64)
            fgpa_values.append(fgpa_fn(pred, mask, binary))

    report = {"accuracy": totals["correct"] / max(totals["total"], 1)}
    for label, (tp, fp, fn) in per_label.items():
        precision, recall, f1 = f1_measures(tp, fp, fn)
        report[f"label_{label}"] = {"precision": precision, "recall": recall, "f1": f1}
    if fgpa_values:
        report["fgpa"] = float(np.mean(fgpa_values))
    print(json.dumps(report, indent=2))
    return 0


# ----------------------------------------------------------------- gen-masks
def cmd_gen_masks(args) -> int:
    from ..core.colors import ColorMap
    from ..pagexml.mask_gen import MaskGenerator, MaskSetting, MaskType, PageXMLTypes, PCGTSVersion

    setting = MaskSetting(
        mask_extension=args.mask_extension,
        mask_type=MaskType(args.setting),
        pcgts_version=PCGTSVersion(args.pcgts_version) if args.pcgts_version else None,
        line_width=args.line_width,
        capital_is_text=args.capital_is_text,
        use_xml_filename=args.use_xml_filename,
    )
    generator = MaskGenerator(setting)
    xml_files = _expand(args.input) or [
        os.path.join(args.input_dir, f) for f in sorted(os.listdir(args.input_dir))
        if f.endswith(".xml")
    ]
    if args.threads and args.threads > 1:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=args.threads) as pool:
            list(pool.map(lambda x: generator.save(x, args.output_dir), xml_files))
    else:
        for xml_file in xml_files:
            generator.save(xml_file, args.output_dir)
    map_dir = args.image_map_dir or args.output_dir
    os.makedirs(map_dir, exist_ok=True)
    map_path = os.path.join(map_dir, "image_map.json")
    ColorMap(PageXMLTypes.image_map(setting.mask_type)).save(map_path)
    print(f"Generated {len(xml_files)} masks + {map_path}")
    return 0


# --------------------------------------------------------- page-segmentation
def cmd_page_segmentation(args) -> int:
    """Region segmentation through ``segmentation.batch.PageSegmenter``:
    decode-ahead, the indexed-PNG fast path, and with ``--morph_backend
    device`` the batched morphology chain on ``--device``."""
    from ..segmentation.batch import PageSegmenter

    segmenter = PageSegmenter(
        _load_color_map(args.color_map),
        args.resize_height,
        args.text_contours,
        args.output_dir,
        extension=args.extension,
        xml_output_dir=args.xml_output_dir,
        backend=args.morph_backend,
        batch_size=args.seg_batch,
        device=args.device,
    )
    for _ in segmenter.run((p, args.char_height) for p in _expand(args.prediction)):
        pass
    return 0


# -------------------------------------------------------------------- parser
class _DashAliasParser(argparse.ArgumentParser):
    """Accepts every dash/underscore spelling of a flag: option tokens are
    normalized (dashes -> underscores) against the registered snake_case
    names before parsing."""

    def parse_known_args(self, args=None, namespace=None):
        if args is None:
            args = sys.argv[1:]
        return super().parse_known_args([self._canonical(a) for a in args], namespace)

    def _canonical(self, token: str) -> str:
        if not token.startswith("--"):
            return token
        body, eq, value = token[2:].partition("=")
        candidate = "--" + body.replace("-", "_")
        if candidate in self._option_string_actions:
            return candidate + (eq + value if eq else "")
        return token


def build_parser() -> argparse.ArgumentParser:
    parser = _DashAliasParser(
        prog="page-segmentation-tpu-torch",
        description="page segmentation (pixel classifier) toolkit, PyTorch/CUDA port",
    )
    sub = parser.add_subparsers(dest="command", required=True, parser_class=_DashAliasParser)
    device_help = "cuda (default): the card, raising without one; cpu: the CPU"

    # predict
    p = sub.add_parser("predict", help="run a model over images")
    p.add_argument("--load", required=True, help="model checkpoint dir")
    p.add_argument("--output", required=True)
    p.add_argument("--images", required=True)
    p.add_argument("--binary", default=None)
    p.add_argument("--binarize", default="threshold", choices=["threshold", "otsu"],
                   help="how pages WITHOUT --binary are binarized from the image "
                        "itself: global threshold 128 or per-page Otsu")
    p.add_argument("--norm", default=None, help="directory of char_height JSON files")
    p.add_argument("--auto_norm", action="store_true",
                   help="estimate char_height per page (Otsu + letter-CC median, the "
                        "compute-image-normalizations backend) when neither --norm nor "
                        "--char_height provides it")
    p.add_argument("--char_height", type=int, default=None)
    p.add_argument("--target_line_height", type=int, default=6)
    p.add_argument("--max_width", type=int, default=None)
    p.add_argument("--color_map", default=None)
    p.add_argument("--n_classes", type=int, default=None)
    p.add_argument("--post_process", nargs="*", default=None)
    p.add_argument("--high_res_output", action="store_true")
    p.add_argument("--fast", action="store_true", help="batched device pipeline")
    p.add_argument("--streaming", action="store_true",
                   help="keep page pixels on disk until their batch runs (shapes "
                        "peeked from the image headers)")
    p.add_argument("--pipeline", action="store_true",
                   help="raw-corpus streaming: pages grouped by (shape, line height) "
                        "through the throughput path (host decimate, device resample, "
                        "forward and argmax, one upload and one packed download per "
                        "batch); outputs at the normalized scale")
    p.add_argument("--int8", action="store_true", help="int8 inference (ROADMAP queue 1 item 13)")
    p.add_argument("--s2d_stem", action="store_true",
                   help="space-to-depth stem rewrite (ROADMAP queue 1 item 13)")
    p.add_argument("--n_devices", type=int, default=None,
                   help="spatial partitioning over devices (ROADMAP queue 1 item 12)")
    p.add_argument("--spatial_threshold", type=int, default=16_000_000)
    p.add_argument("--band_rows", type=int, default=None,
                   help="banded forward of tall pages (ROADMAP queue 1 item 12)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--resize_backend", default="scipy", choices=["scipy", "pil"])
    p.add_argument("--gpu_allow_growth", action="store_true")  # accepted, no effect
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    p.set_defaults(func=cmd_predict)

    # train
    t = sub.add_parser("train", help="train a model from dataset JSON files")
    for flag in ("--train", "--test", "--eval"):
        t.add_argument(flag, nargs="*", default=None)
    t.add_argument("--split_file", default=None)
    t.add_argument("--output", required=True)
    t.add_argument("--n_iter", type=int, default=None)
    t.add_argument("--n_epoch", type=int, default=100)
    t.add_argument("--l_rate", type=float, default=1e-4)
    t.add_argument("--target_line_height", type=int, default=6)
    t.add_argument("--max_width", type=int, default=None)
    t.add_argument("--n_classes", type=int, default=None)
    t.add_argument("--color_map", default=None)
    t.add_argument("--architecture", default="fcn_skip")
    t.add_argument("--loss", default="categorical_crossentropy")
    t.add_argument("--monitor", default="val_loss")
    t.add_argument("--optimizer", default="adam")
    t.add_argument("--early_stopping_max_performance_drops", type=int, default=30)
    for flag in ("--data_augmentation", "--balanced_sampling", "--device_augmentation",
                 "--export_h5", "--remat", "--foreground_masks", "--compute_baseline",
                 "--tensorboard", "--continue_training", "--auto_resume", "--streaming",
                 "--distributed"):
        t.add_argument(flag, action="store_true")
    t.add_argument("--balanced_sampling_strength", type=float, default=0.5)
    t.add_argument("--class_weighting", type=float, default=0.0)
    t.add_argument("--checkpoint_backend", default="msgpack", choices=["msgpack", "orbax"])
    t.add_argument("--load", default=None)
    t.add_argument("--pretrained_encoder", default=None)
    t.add_argument("--batch_size", type=int, default=1)
    t.add_argument("--grad_accum", type=int, default=1)
    t.add_argument("--skip_nonfinite", type=int, default=0)
    t.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"])
    t.add_argument("--lr_warmup_steps", type=int, default=0)
    t.add_argument("--lr_decay_steps", type=int, default=None)
    t.add_argument("--lr_min_fraction", type=float, default=0.0)
    t.add_argument("--n_devices", type=int, default=None)
    t.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    t.add_argument("--resize_backend", default="scipy", choices=["scipy", "pil"])
    t.add_argument("--display", type=int, default=100)
    t.add_argument("--threads", type=int, default=8)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    t.set_defaults(func=cmd_train)

    # create-dataset-file
    c = sub.add_parser("create-dataset-file", help="build dataset JSON from a dataset dir")
    c.add_argument("--dataset_path", nargs="+", required=True)
    c.add_argument("--output_file", default="dataset.json")
    c.add_argument("--character_height", type=int, default=None)
    c.add_argument("--n_train", type=float, default=-1)
    c.add_argument("--n_test", type=float, default=0)
    c.add_argument("--n_eval", type=float, default=0)
    c.add_argument("--binary_dir", default="binary_images")
    c.add_argument("--images_dir", default="images")
    c.add_argument("--masks_dir", default="masks")
    c.add_argument("--masks_postfix", default="")
    c.add_argument("--normalizations_dir", default="normalizations")
    c.add_argument("--verify_filenames", action="store_true")
    c.set_defaults(func=cmd_create_dataset_file)

    # compute-image-normalizations
    n = sub.add_parser("compute-image-normalizations", help="estimate char heights")
    n.add_argument("--input_dir", required=True)
    n.add_argument("--output_dir", required=True)
    n.add_argument("--average_all", action="store_true")
    n.add_argument("--inverse", action="store_true")
    n.set_defaults(func=cmd_compute_normalizations)

    # gen-masks
    g = sub.add_parser("gen-masks", help="PageXML -> color mask PNGs")
    g.add_argument("--input", nargs="*", default=None, help="xml files/globs")
    g.add_argument("--input_dir", default=None)
    g.add_argument("--output_dir", required=True)
    g.add_argument("--setting", default="all_types",
                   choices=["all_types", "text_nontext", "baseline", "textline", "text_only"])
    g.add_argument("--mask_extension", default="png")
    g.add_argument("--pcgts_version", default=None, choices=["2019", "2017", "2013", "2010"])
    g.add_argument("--line_width", type=int, default=5)
    g.add_argument("--capital_is_text", action="store_true")
    g.add_argument("--use_xml_filename", action="store_true")
    g.add_argument("--threads", type=int, default=1,
                   help="parallel mask rasterization workers")
    g.add_argument("--image_map_dir", default=None,
                   help="write image_map.json here instead of output_dir")
    g.set_defaults(func=cmd_gen_masks)

    # page-segmentation
    s = sub.add_parser("page-segmentation", help="XY-cut/morphological region segmentation")
    s.add_argument("--prediction", nargs="+", required=True)
    s.add_argument("--output_dir", required=True)
    s.add_argument("--char_height", type=int, required=True)
    s.add_argument("--resize_height", type=int, default=300)
    s.add_argument("--color_map", default=None)
    s.add_argument("--text_contours", action="store_true", help="morphological text polygons")
    s.add_argument("--xml_output_dir", default=None,
                   help="also write the regions as PageXML documents here")
    s.add_argument("--extension", default="png")
    s.add_argument("--morph_backend", default="auto", choices=["auto", "device", "host"],
                   help="text-contours morphology: host (= auto) runs the native bit-packed "
                        "chain page by page; device runs one batched torch chain on --device")
    s.add_argument("--seg_batch", type=int, default=8,
                   help="pages per pipeline batch (decode prefetch, one device chain)")
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where --morph_backend device runs")
    s.set_defaults(func=cmd_page_segmentation)

    # serve
    v = sub.add_parser("serve", help="HTTP prediction service with dynamic batching")
    v.add_argument("--load", required=True, help="model checkpoint dir")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--port", type=int, default=8765)
    v.add_argument("--char_height", type=int, default=None,
                   help="default line height (px) for requests that omit ?char_height=N")
    v.add_argument("--target_line_height", type=int, default=6)
    v.add_argument("--max_width", type=int, default=None)
    v.add_argument("--color_map", default=None)
    v.add_argument("--n_classes", type=int, default=None)
    v.add_argument("--post_process", nargs="*", default=None)
    v.add_argument("--max_batch", type=int, default=16,
                   help="max pages in one device dispatch")
    v.add_argument("--max_wait_ms", type=float, default=25.0,
                   help="batching window: how long the first request of a batch waits for riders")
    v.add_argument("--max_queue", type=int, default=0,
                   help="backpressure: reject (HTTP 503 + Retry-After) new pages beyond "
                        "this many pending; 0 = unbounded")
    v.add_argument("--dtype", default="bfloat16", choices=["float32", "bfloat16"])
    v.add_argument("--prepare", default="fused", choices=["fused", "spline"],
                   help="fused (default): requests ride the throughput path; spline: the "
                        "per-page host prepare.  Configurations the fused path cannot "
                        "express (max_width, post-processors other than cc_majority) use "
                        "spline")
    v.add_argument("--resize_backend", default="scipy", choices=["scipy", "pil"],
                   help="the spline prepare's resize")
    v.add_argument("--s2d_stem", action="store_true")
    v.add_argument("--int8", action="store_true")
    v.add_argument("--device", default="cuda", choices=["cuda", "cpu"], help=device_help)
    v.set_defaults(func=cmd_serve)

    # export
    x = sub.add_parser("export", help="serialize the predict program (not ported yet)")
    x.add_argument("--load", required=True)
    x.add_argument("--output", required=True)
    x.add_argument("--architecture", default="fcn_skip")
    x.add_argument("--color_map", default=None)
    x.add_argument("--n_classes", type=int, default=None)
    x.add_argument("--logits", action="store_true")
    x.add_argument("--platforms", nargs="+", default=["tpu", "cpu"])
    x.add_argument("--shapes", nargs="*", default=None, metavar="HxW")
    x.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    x.add_argument("--s2d_stem", action="store_true")
    x.set_defaults(func=_not_ported("13", "a torch.export artifact"))

    # evaluate
    e = sub.add_parser("evaluate", help="compare predictions against masks")
    e.add_argument("--masks", required=True)
    e.add_argument("--predictions", required=True)
    e.add_argument("--binary", default=None)
    e.add_argument("--color_map", default=None)
    e.set_defaults(func=cmd_evaluate)

    return parser


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    if argv is None:
        argv = sys.argv[1:]
    # a bare invocation is predict
    if argv and argv[0].startswith("-") and argv[0] not in ("-h", "--help"):
        argv = ["predict"] + list(argv)
    args = build_parser().parse_args(argv)
    try:
        return args.func(args)
    except (FileNotFoundError, NotADirectoryError, IsADirectoryError) as exc:
        # user-input errors: one line, not a traceback (PS_TPU_TRACEBACK=1
        # re-raises)
        if os.environ.get("PS_TPU_TRACEBACK"):
            raise
        print(f"error: no such file or directory: {getattr(exc, 'filename', None) or exc}",
              file=sys.stderr)
        return 2
    except NotImplementedError as exc:
        if os.environ.get("PS_TPU_TRACEBACK"):
            raise
        print(f"error: {exc}", file=sys.stderr)
        return 2
    except ValueError as exc:
        if os.environ.get("PS_TPU_TRACEBACK"):
            raise
        # one line for user-input mistakes, naming the raise site so that an
        # internal error is still found
        tb = exc.__traceback__
        while tb is not None and tb.tb_next is not None:
            tb = tb.tb_next
        origin = (f" [{os.path.basename(tb.tb_frame.f_code.co_filename)}:{tb.tb_lineno}]"
                  if tb is not None else "")
        print(f"error: {exc}{origin}\n(set PS_TPU_TRACEBACK=1 for the full traceback)",
              file=sys.stderr)
        return 2


def main_compute_normalizations(argv=None) -> int:
    """The ``ocrd_compute_normalizations`` alias of compute-image-normalizations."""
    if argv is None:
        argv = sys.argv[1:]
    return main(["compute-image-normalizations"] + list(argv))


if __name__ == "__main__":
    sys.exit(main())
