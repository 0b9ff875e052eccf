"""The port stands alone: no module of page_segmentation_tpu_torch, and not
chip_smoke.py, imports jax, flax, optax or the JAX package; and its entry
points run on the card by default, raising where there is none."""
import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "page_segmentation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "page_segmentation_tpu")
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_sources_import_nothing_of_jax(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def _code_strings(path):
    """The string constants of a source that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docstrings = {id(node.value) for node in ast.walk(tree)
                  if isinstance(node, ast.Expr) and isinstance(node.value, ast.Constant)}
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docstrings:
            yield node.value


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_sources_name_no_path_in_the_jax_package(path):
    """No string the code uses names the JAX package's directory, as a path
    to a file there (a manifest, a library) or as one of its parts; a
    ``file.py:line`` citation (``chip_smoke.py``'s ``replaces``) opens
    nothing."""
    for text in _code_strings(path):
        if re.fullmatch(r"[\w/.]+\.py:\d+", text):
            continue
        parts = text.replace("\\", "/").split("/")
        assert "page_segmentation_tpu" not in parts, f"{path.name} names {text!r}"


def test_port_opens_no_file_of_the_jax_package(monkeypatch):
    """The .h5 exporter reads the port's own copy of the recorded Keras
    manifests (equal to the JAX package's), never the JAX package's file."""
    import builtins

    from page_segmentation_tpu_torch.models import h5_export

    jax_package = (REPO / "page_segmentation_tpu").resolve()
    opened = []
    real_open = builtins.open

    def recording_open(file, *args, **kwargs):
        opened.append(Path(os.fspath(file)).resolve())
        return real_open(file, *args, **kwargs)

    h5_export._manifests.cache_clear()  # read the file here, not from an earlier test's cache
    monkeypatch.setattr(builtins, "open", recording_open)
    manifests = h5_export._manifests()
    for family in ("mobile_net", "image_res_net", "effb0"):
        assert h5_export._load_manifest(family)["layers"]
    monkeypatch.undo()
    assert opened and all(jax_package not in p.parents for p in opened), opened
    assert opened[0].parent == PORT / "models"
    jax_copy = jax_package / "models" / "h5_export_manifests.json"
    assert json.loads(jax_copy.read_text()) == manifests


def test_importing_the_port_loads_no_jax():
    modules = [
        "page_segmentation_tpu_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in sorted(PORT.rglob("*.py")) if p.name != "__init__.py"
    ]
    code = (
        "import sys, importlib\n"
        "import page_segmentation_tpu_torch\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith("ok")


def _entry_points():
    from page_segmentation_tpu_torch.core.colors import DEFAULT_IMAGE_MAP
    from page_segmentation_tpu_torch.inference.classifier import PixelClassifier
    from page_segmentation_tpu_torch.inference.aot import AotClassifier
    from page_segmentation_tpu_torch.inference.postprocess import cc_vote_on_device
    from page_segmentation_tpu_torch.inference.predictor import Predictor, PredictSettings
    from page_segmentation_tpu_torch.inference.pipeline import (
        ThroughputPredictor,
        make_fused_predict,
    )
    from page_segmentation_tpu_torch.models.fcn import FCNSkip
    from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc
    from page_segmentation_tpu_torch.tools import repro_download, train_quality
    from page_segmentation_tpu_torch.core.colors import ColorMap
    from page_segmentation_tpu_torch.data.dataset import Dataset
    from page_segmentation_tpu_torch.cli.main import main as cli_main
    from page_segmentation_tpu_torch.network import Network
    from page_segmentation_tpu_torch.train.trainer import Trainer, TrainSettings
    from page_segmentation_tpu_torch.parallel import distributed
    from page_segmentation_tpu_torch.parallel.mesh import make_mesh

    ink = np.ones((8, 8), np.uint8)
    empty = Dataset([], ColorMap({(255, 255, 255): (0, "background")}))
    return {
        "ThroughputPredictor": lambda: ThroughputPredictor(
            FCNSkip(3), None, DEFAULT_IMAGE_MAP.palette, (400, 296), 6 / 50),
        "make_fused_predict": lambda: make_fused_predict(FCNSkip(3), (48, 36)),
        "cc_min_label": lambda: cuda_cc.cc_min_label(ink),
        "cc_min_label_batch": lambda: cuda_cc.cc_min_label_batch(ink[None]),
        "cc_min_label_tiled": lambda: cuda_cc.cc_min_label_tiled(ink),
        "cc_vote_batch": lambda: cuda_cc.cc_vote_batch(ink[None], ink[None], 3),
        "PixelClassifier": lambda: PixelClassifier(3),
        "Predictor": lambda: Predictor(PredictSettings(n_classes=3, network="missing")),
        "cc_vote_on_device": lambda: cc_vote_on_device(ink, ink, 3),
        "add_one": lambda: cuda_add_one.add_one(ink),
        "repro_download.main": lambda: repro_download.main(trials=1),
        "Trainer": lambda: Trainer(TrainSettings(
            n_epoch=0, n_classes=2, l_rate=1e-3, train_data=empty, validation_data=None,
            display=0, output_dir="unused", threads=1)),
        "Network": lambda: Network("train", n_classes=3),
        "train CLI": lambda: cli_main(["train", "--output", "unused"]),
        "AotClassifier": lambda: AotClassifier("unused.zip"),
        "make_mesh": lambda: make_mesh(2),
        "distributed.initialize": lambda: distributed.initialize("127.0.0.1:1", 1, 0),
        "distributed.global_mesh": lambda: distributed.global_mesh(),
        "Trainer(n_devices=2)": lambda: Trainer(TrainSettings(
            n_epoch=0, n_classes=2, l_rate=1e-3, train_data=empty, validation_data=None,
            display=0, output_dir="unused", threads=1, n_devices=2)),
        "train_quality.main": lambda: train_quality.main(["--n-epoch", "1"]),
    }


@pytest.mark.parametrize("name", ["ThroughputPredictor", "make_fused_predict", "cc_min_label",
                                  "cc_min_label_batch", "cc_min_label_tiled", "cc_vote_batch",
                                  "PixelClassifier", "Predictor", "cc_vote_on_device", "add_one",
                                  "repro_download.main", "Trainer", "Network", "train CLI",
                                  "AotClassifier", "make_mesh", "distributed.initialize",
                                  "distributed.global_mesh", "Trainer(n_devices=2)",
                                  "train_quality.main"])
def test_default_device_is_cuda_and_raises_without_a_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        _entry_points()[name]()


def test_cpu_tensor_takes_the_plain_labeler(monkeypatch):
    from page_segmentation_tpu_torch.ops import cuda_cc

    def no_kernel(ink):
        raise AssertionError("the CUDA kernel must not run for a CPU tensor")

    monkeypatch.setattr(cuda_cc, "_label_cuda", no_kernel)
    before = cuda_cc.launches
    labels, _ = cuda_cc.cc_min_label_batch(np.ones((2, 4, 4), np.uint8), device="cpu")
    assert (labels == 1).all() and cuda_cc.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    from page_segmentation_tpu_torch.ops import cuda_cc

    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_cc._label_cuda(torch.ones((1, 4, 4), dtype=torch.bool))


def test_importing_the_port_binds_no_kernel():
    """Kernels are built and bound at their first launch, never on import."""
    code = (
        "from page_segmentation_tpu_torch import _kernels\n"
        "from page_segmentation_tpu_torch.ops import cuda_add_one, cuda_cc\n"
        "from page_segmentation_tpu_torch.inference import pipeline, classifier, predictor\n"
        "assert cuda_cc._CC_LABEL.fn is None and cuda_add_one._ADD_ONE.fn is None\n"
        "assert not _kernels._loaded\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith("ok")


@pytest.mark.parametrize("device, same", [("cuda", True), (torch.device("cuda"), True),
                                          ("cuda:3", False), (torch.device("cuda", 3), False),
                                          ("cpu", False)])
def test_on_card_names_the_tensors_own_card(device, same):
    """``device.on_card``: CUDA without an index names the tensor's own card;
    an index must match it (a CPU tensor's ``get_device()`` is -1, so no
    index matches here)."""
    from page_segmentation_tpu_torch.device import on_card

    assert on_card(torch.zeros(2), device) is same

