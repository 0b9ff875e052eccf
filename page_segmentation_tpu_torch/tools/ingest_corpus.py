"""One-command ingest: page scans and their PAGE-XML become a dataset ready
to train on.

Port of ``tools/ingest_corpus.py``, with the same flags, driving the port's
CLI and ``ops/threshold``:

    python -m page_segmentation_tpu_torch.tools.ingest_corpus \\
        --images /path/scans --xml /path/page_xml --output /path/dataset \\
        [--binary /path/binarized] [--setting all_types] \\
        [--n-train -1 --n-test 10 --n-eval 10] [--seed 3]

Steps:
  1. ``gen-masks``: PAGE-XML -> color mask PNGs and ``image_map.json``;
  2. binaries: the ``--binary`` directory copied, or the scans Otsu-binarized
     and written as 1-bit PNGs;
  3. ``compute-image-normalizations``: each page's char height;
  4. ``create-dataset-file``: the train/test/eval split JSON.

Output: ``<output>/{images,binary_images,masks,normalizations}/``,
``<output>/image_map.json`` and ``<output>/dataset.json``.  Every step is
host code (the native rasterizer, numpy), so the tool takes no device.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import shutil
import sys

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--images", required=True, help="raw scan directory")
    parser.add_argument("--xml", required=True, help="PAGE-XML directory")
    parser.add_argument("--binary", default=None,
                        help="pre-binarized pages (copied as they are); omitted = "
                             "Otsu-binarize the scans, stored as 1-bit PNGs")
    parser.add_argument("--output", required=True, help="dataset root to build")
    parser.add_argument("--setting", default="all_types",
                        choices=["all_types", "text_nontext", "baseline", "textline", "text_only"])
    parser.add_argument("--pcgts-version", default=None, choices=["2019", "2017", "2013", "2010"])
    parser.add_argument("--average-all", action="store_true",
                        help="use the corpus-average char height for every page "
                             "(ocrd_compute_normalizations --average_all)")
    parser.add_argument("--n-train", type=float, default=-1)
    parser.add_argument("--n-test", type=float, default=0)
    parser.add_argument("--n-eval", type=float, default=0)
    parser.add_argument("--seed", type=int, default=None,
                        help="shuffle seed for the split (default: random)")
    return parser


def otsu_binaries(names, images_dir: str, out_dir: str) -> None:
    """Binarize each scan at its Otsu threshold and write it as a 1-bit PNG
    (pixels strictly above the threshold are paper, as cv2 has it)."""
    import numpy as np

    from ..core.image_io import imread, imsave_bilevel
    from ..ops.threshold import otsu_threshold

    for name in names:
        gray = imread(os.path.join(images_dir, name), as_gray=True)
        thresh = otsu_threshold(gray) + 1
        stem = os.path.splitext(name)[0]
        imsave_bilevel(os.path.join(out_dir, stem + ".png"),
                       (gray >= thresh).astype(np.uint8) * 255)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..cli.main import main as cli

    out = args.output
    dirs = {s: os.path.join(out, s) for s in ("images", "binary_images", "masks", "normalizations")}
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)

    # 1. masks from PAGE-XML, the image map moved to the dataset root
    rc = cli(["gen-masks", "--input_dir", args.xml, "--output_dir", dirs["masks"],
              "--setting", args.setting]
             + (["--pcgts_version", args.pcgts_version] if args.pcgts_version else []))
    if rc != 0:
        return rc
    map_src = os.path.join(dirs["masks"], "image_map.json")
    image_map = os.path.join(out, "image_map.json")
    if os.path.exists(map_src):
        shutil.move(map_src, image_map)

    # 2. images and binaries
    names = sorted(n for n in os.listdir(args.images) if n.lower().endswith(IMAGE_EXTS))
    if not names:
        print(f"no images found under {args.images}", file=sys.stderr)
        return 1
    for name in names:
        dst = os.path.join(dirs["images"], name)
        if not os.path.exists(dst):
            shutil.copy(os.path.join(args.images, name), dst)
    if args.binary:
        for name in names:
            src = os.path.join(args.binary, name)
            if not os.path.exists(src):
                print(f"missing binary for {name} under {args.binary}", file=sys.stderr)
                return 1
            shutil.copy(src, os.path.join(dirs["binary_images"], name))
    else:
        otsu_binaries(names, args.images, dirs["binary_images"])

    # 3. each page's char height from its binary
    rc = cli(["compute-image-normalizations", "--input_dir", dirs["binary_images"],
              "--output_dir", dirs["normalizations"]]
             + (["--average_all"] if args.average_all else []))
    if rc != 0:
        return rc

    # 4. the split file
    if args.seed is not None:
        random.seed(args.seed)
    dataset_json = os.path.join(out, "dataset.json")
    rc = cli(["create-dataset-file", "--dataset_path", out, "--output_file", dataset_json,
              "--n_train", str(args.n_train), "--n_test", str(args.n_test),
              "--n_eval", str(args.n_eval), "--verify_filenames"])
    if rc != 0:
        return rc
    with open(dataset_json) as f:
        split = json.load(f)
    print(json.dumps({
        "dataset": out,
        "pages": len(names),
        "train": len(split["train"]),
        "test": len(split["test"]),
        "eval": len(split["eval"]),
        "image_map": image_map,
        "dataset_json": dataset_json,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
