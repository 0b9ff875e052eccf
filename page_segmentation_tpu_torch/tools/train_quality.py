"""Training quality on the golden corpus: what a model trained by the port
is worth on pages it never saw.

Port of ``tools/train_quality.py``.  It runs the reference workflow through
the port's CLI over the 11-page golden corpus (``tests/golden_corpus``):
``gen-masks`` -> ``create-dataset-file`` -> ``train`` -> ``predict --fast
--high_res_output`` -> ``evaluate``, on a seeded (n-3)/1/2 train/val/eval
split, and reports held-out pixel accuracy, per-label F1 and FgPA
(foreground pixel accuracy).  The best checkpoint is selected on the val
page; the metrics come from the two eval pages, which no model selection
sees.

    python -m page_segmentation_tpu_torch.tools.train_quality --monitor val_accuracy \\
        [--device cpu] [--n-epoch 300] [--record quality.json]

The split search seeds ``random`` before each ``create-dataset-file`` and
walks seeds from ``--seed`` until the eval pages hold every class, the val
page holds every class and every class is in at least two train pages; the
port's ``create-dataset-file`` makes the same draws as the JAX CLI's, so the
split is the JAX tool's.  ``train`` and ``predict`` run on ``--device``
(default ``cuda``).  The result is printed as one JSON object with the keys
of the JAX tool's record; ``--record PATH`` also writes it to ``PATH``.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import random
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

CORPUS = str(Path(__file__).resolve().parents[2] / "tests" / "golden_corpus")

MODE = ("full reference workflow (gen-masks -> create-dataset-file -> train -> predict --fast "
        "--high_res_output -> evaluate) on the 11-page golden corpus, seeded (n-3)/1/2 "
        "train/val/eval split; best checkpoint selected on the VAL page, metrics on the 2 "
        "untouched eval pages (no model selection leak)")


def _check(rc: int, step: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{step} exited with {rc}")


def stage_golden_split(tmp: str, cli, base_seed: int = 7) -> dict:
    """Stage the corpus as a dataset directory and draw a testable and
    learnable (n-3)/1/2 train/val/eval split.

    Walks seeds from ``base_seed`` until the eval pages together hold every
    class, the val page (which selects the checkpoint) holds every class, and
    every class is in at least 2 train pages.  Returns the staged paths and
    the seed."""
    from ..core.colors import ColorMap

    ds = os.path.join(tmp, "ds")
    for sub in ("binary_images", "images", "masks", "normalizations"):
        os.makedirs(os.path.join(ds, sub), exist_ok=True)
    _check(cli(["gen-masks", "--input_dir", os.path.join(CORPUS, "xml"),
                "--output_dir", os.path.join(ds, "masks"), "--setting", "text_nontext"]),
           "gen-masks")
    with open(os.path.join(CORPUS, "frozen.json")) as f:
        frozen = json.load(f)
    n_pages = len(frozen["char_height"])
    for i in range(n_pages):
        for sub, src in (("images", "images"), ("binary_images", "binary")):
            shutil.copy(os.path.join(CORPUS, src, f"page{i}.png"),
                        os.path.join(ds, sub, f"page{i}.png"))
        with open(os.path.join(ds, "normalizations", f"page{i}.json"), "w") as f:
            json.dump({"char_height": frozen["char_height"][f"page{i}"]}, f)
    image_map = os.path.join(tmp, "image_map.json")
    shutil.move(os.path.join(ds, "masks", "image_map.json"), image_map)

    cmap = ColorMap.load(image_map)
    dataset_json = os.path.join(tmp, "dataset.json")

    def page_of(entry) -> str:
        return os.path.splitext(os.path.basename(entry["image_path"]))[0]

    def classes_of(entries):
        return [set(np.unique(cmap.imread_labels(
            os.path.join(ds, "masks", f"{page_of(e)}.mask.png"))).tolist()) for e in entries]

    all_classes = set(range(cmap.n_classes))
    for seed in range(base_seed, base_seed + 50):
        random.seed(seed)
        _check(cli(["create-dataset-file", "--dataset_path", ds, "--output_file", dataset_json,
                    "--n_train", str(n_pages - 3), "--n_test", "1", "--n_eval", "2"]),
               "create-dataset-file")
        with open(dataset_json) as f:
            split = json.load(f)
        test_pages = sorted(page_of(e) for e in split["eval"])
        eval_cover = set().union(*classes_of(split["eval"]))
        val_cover = set().union(*classes_of(split["test"]))
        train_sets = classes_of(split["train"])
        train_ok = all(sum(label in s for s in train_sets) >= 2 for label in all_classes)
        if eval_cover == all_classes and val_cover == all_classes and train_ok:
            return {"ds": ds, "image_map": image_map, "dataset_json": dataset_json,
                    "test_pages": test_pages, "split_seed": seed, "n_pages": n_pages,
                    "cmap": cmap}
        print(f"seed {seed}: eval covers {sorted(eval_cover)}, val covers {sorted(val_cover)}, "
              f"train_ok={train_ok}; redrawing", file=sys.stderr)
    raise RuntimeError("no seed produced a testable and learnable split")


def stage_held_out(tmp: str, ds: str, test_pages, cmap) -> str:
    """Copy the held-out pages (images, binaries, normalizations, ground
    truth under the prediction's file name) for predict and evaluate; the
    ground truth must hold every class."""
    held = os.path.join(tmp, "held")
    for sub in ("images", "binary", "norm", "gt_masks"):
        os.makedirs(os.path.join(held, sub), exist_ok=True)
    for page in test_pages:
        shutil.copy(os.path.join(CORPUS, "images", f"{page}.png"),
                    os.path.join(held, "images", f"{page}.png"))
        shutil.copy(os.path.join(CORPUS, "binary", f"{page}.png"),
                    os.path.join(held, "binary", f"{page}.png"))
        shutil.copy(os.path.join(ds, "normalizations", f"{page}.json"),
                    os.path.join(held, "norm", f"{page}.json"))
        shutil.copy(os.path.join(ds, "masks", f"{page}.mask.png"),
                    os.path.join(held, "gt_masks", f"{page}.png"))
    gt_classes = set()
    for page in test_pages:
        gt_classes.update(np.unique(cmap.imread_labels(
            os.path.join(held, "gt_masks", f"{page}.png"))).tolist())
    if gt_classes != set(range(cmap.n_classes)):
        raise RuntimeError(f"held-out ground truth covers only classes {sorted(gt_classes)}")
    return held


def run_evaluate(cli, held: str, pred_color_dir: str, image_map: str, test_pages) -> dict:
    """The ``evaluate`` report of the predictions against the ground truth;
    every held-out page must have been predicted and paired."""
    predicted = sorted(os.path.splitext(n)[0] for n in os.listdir(pred_color_dir))
    if predicted != list(test_pages):
        raise RuntimeError(f"predicted pages {predicted} are not the held-out {list(test_pages)}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli(["evaluate", "--masks", os.path.join(held, "gt_masks"),
                  "--predictions", pred_color_dir, "--binary", os.path.join(held, "binary"),
                  "--color_map", image_map])
    _check(rc, "evaluate")
    report = json.loads(buf.getvalue())
    if "fgpa" not in report:
        raise RuntimeError(f"evaluate reported no fgpa: {report}")
    return report


def predict_args(model: str, held: str, out: str, image_map: str,
                 target_line_height: int, device: str):
    """The ``predict --fast --high_res_output`` command over the held-out pages."""
    return ["predict", "--load", model, "--output", out, "--fast",
            "--images", os.path.join(held, "images"), "--binary", os.path.join(held, "binary"),
            "--norm", os.path.join(held, "norm"), "--color_map", image_map,
            "--target_line_height", str(target_line_height), "--high_res_output",
            "--device", device]


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    # the recipe of the JAX tool's record: lr 3e-4 and up to 300 epochs let
    # the image class (~4 % of the pixels) train before early stopping
    parser.add_argument("--n-epoch", type=int, default=300)
    parser.add_argument("--l-rate", type=float, default=3e-4)
    parser.add_argument("--target-line-height", type=int, default=10)
    parser.add_argument("--seed", type=int, default=7)
    parser.add_argument("--augment", action="store_true", default=True)
    parser.add_argument("--no-augment", dest="augment", action="store_false")
    parser.add_argument("--loss", default="categorical_crossentropy")
    parser.add_argument("--monitor", default="val_loss",
                        help="checkpoint selection and early stopping; val_accuracy is "
                             "recommended with the class-balance levers")
    parser.add_argument("--balanced-sampling", action="store_true",
                        help="class-balanced page sampling (see the trainer)")
    parser.add_argument("--balanced-sampling-strength", type=float, default=0.5)
    parser.add_argument("--class-weighting", type=float, default=0.0,
                        help="per-class loss weight exponent beta")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where train and predict run (default: the card)")
    parser.add_argument("--record", default=None, metavar="PATH",
                        help="also write the result JSON to PATH")
    return parser


def run_workflow(args, work: str) -> dict:
    """Stage, train, predict and evaluate under ``work``.  Returns the
    record, with the staged paths under ``"paths"``."""
    from ..cli.main import main as cli

    staged = stage_golden_split(work, cli, args.seed)
    ds, image_map = staged["ds"], staged["image_map"]
    test_pages, n_pages = staged["test_pages"], staged["n_pages"]

    out = os.path.join(work, "train_out")
    t0 = time.monotonic()
    rc = cli(["train", "--split_file", staged["dataset_json"], "--output", out,
              "--n_epoch", str(args.n_epoch), "--l_rate", str(args.l_rate),
              "--color_map", image_map, "--loss", args.loss,
              "--target_line_height", str(args.target_line_height), "--seed", "0",
              "--monitor", args.monitor, "--class_weighting", str(args.class_weighting),
              "--balanced_sampling_strength", str(args.balanced_sampling_strength),
              "--device", args.device]
             + (["--data_augmentation"] if args.augment else [])
             + (["--balanced_sampling"] if args.balanced_sampling else []))
    train_seconds = time.monotonic() - t0
    _check(rc, "train")
    with open(os.path.join(out, "scalars.jsonl")) as f:
        scalars = [json.loads(line) for line in f]

    held = stage_held_out(work, ds, test_pages, staged["cmap"])
    pred = os.path.join(work, "pred")
    model = os.path.join(out, "model")
    _check(cli(predict_args(model, held, pred, image_map, args.target_line_height, args.device)),
           "predict")
    report = run_evaluate(cli, held, os.path.join(pred, "color"), image_map, test_pages)

    return {
        "metric": "held_out_fgpa",
        "value": round(report["fgpa"], 4),
        "unit": "fraction",
        "accuracy": round(report["accuracy"], 4),
        "per_label": {k: {m: round(v, 4) if isinstance(v, float) else v for m, v in d.items()}
                      for k, d in report.items() if k.startswith("label_")},
        "test_pages": test_pages,
        "split_seed": staged["split_seed"],
        "eval_gt_covers_all_classes": True,
        "train_pages": n_pages - 3,
        "n_epoch_requested": args.n_epoch,
        "epochs_ran": len(scalars),
        "train_seconds": round(train_seconds, 1),
        "augmented": bool(args.augment),
        "loss": args.loss,
        "balanced_sampling": bool(args.balanced_sampling),
        "balanced_sampling_strength": args.balanced_sampling_strength,
        "class_weighting": args.class_weighting,
        "loss_first": round(scalars[0]["loss"], 4),
        "loss_last": round(scalars[-1]["loss"], 4),
        "mode": MODE,
        "monitor": args.monitor,
        "sweep_note": f"one run of the recipe above on {args.device}; no recipe sweep",
        "paths": {"model": model, "held": held, "pred": pred, "image_map": image_map},
    }


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        result = run_workflow(args, tmp)
    del result["paths"]
    print(json.dumps(result))
    if args.record:
        with open(args.record, "w") as f:
            json.dump(result, f)
            f.write("\n")
        print(f"recorded {args.record}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
