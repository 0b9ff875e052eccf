"""The port's ingest and encoder-provisioning tools
(``page_segmentation_tpu_torch/tools/{ingest_corpus,provision_pretrained}.py``)
against the JAX package's (``tools/``), on the same inputs, on the CPU: the
same dataset tree byte for byte, the same provisioning report and the same
encoder checkpoint bytes, and the encoder loaders they rest on.  The
provisioning tests build random-init Keras backbones with tensorflow and
skip without it."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "golden_corpus"
sys.path.insert(0, str(REPO))

from page_segmentation_tpu_torch.tools import ingest_corpus, provision_pretrained  # noqa: E402
from tools import ingest_corpus as jax_ingest_corpus  # noqa: E402
from tools import provision_pretrained as jax_provision_pretrained  # noqa: E402


def _tree(root: Path):
    return {p.relative_to(root).as_posix(): p for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("binaries", ["provided", "otsu"])
def test_ingest_writes_the_jax_tools_dataset(tmp_path, capsys, binaries):
    common = ["--images", str(CORPUS / "images"), "--xml", str(CORPUS / "xml"),
              "--setting", "text_nontext", "--n-train", "-1", "--n-test", "1", "--n-eval", "2",
              "--seed", "3"]
    if binaries == "provided":
        common += ["--binary", str(CORPUS / "binary")]
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert ingest_corpus.main(common + ["--output", str(port)]) == 0
    port_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jax_ingest_corpus.main(common + ["--output", str(ref)]) == 0
    ref_report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    got, want = _tree(port), _tree(ref)
    assert list(got) == list(want)
    assert sum(name.startswith("masks/") for name in got) == 11
    for name in got:
        if name == "dataset.json":
            assert got[name].read_text().replace(str(port), "<root>") == \
                want[name].read_text().replace(str(ref), "<root>")
        else:
            assert got[name].read_bytes() == want[name].read_bytes(), name
    assert port_report == {k: v.replace(str(ref), str(port)) if isinstance(v, str) else v
                           for k, v in ref_report.items()}


def test_ingest_reports_missing_inputs(tmp_path, capsys):
    (tmp_path / "scans").mkdir()
    args = ["--images", str(tmp_path / "scans"), "--xml", str(CORPUS / "xml"),
            "--output", str(tmp_path / "out")]
    assert ingest_corpus.main(args) == jax_ingest_corpus.main(args) == 1
    args = ["--images", str(CORPUS / "images"), "--xml", str(CORPUS / "xml"),
            "--binary", str(tmp_path / "scans"), "--output", str(tmp_path / "out2")]
    assert ingest_corpus.main(args) == 1
    assert "missing binary" in capsys.readouterr().err


# ------------------------------------------------------------- provisioning
BACKBONES = {  # family: (keras constructor, input side, an architecture of another family)
    "mobilenet": ("MobileNetV2", 96, "image_res_net"),
    "effnet": ("EfficientNetB0", 96, "mobile_net"),
    "resnet": ("ResNet50", 64, "effb0"),
}


@pytest.fixture(scope="module")
def backbones(tmp_path_factory):
    tf = pytest.importorskip("tensorflow")
    made = {}

    def build(family):
        if family not in made:
            name, side, _ = BACKBONES[family]
            tf.keras.utils.set_random_seed(13)
            path = tmp_path_factory.mktemp("bb") / f"{family}.h5"
            getattr(tf.keras.applications, name)(
                weights=None, include_top=False, input_shape=(side, side, 3)).save(str(path))
            made[family] = path
        return made[family]

    return build


def _same_tree(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same_tree(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("family", list(BACKBONES))
def test_provision_writes_the_jax_tools_encoder(backbones, tmp_path, capsys, family):
    h5 = backbones(family)
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert provision_pretrained.main([str(h5), "--out", str(port)]) == 0
    port_report = json.loads(capsys.readouterr().out)
    assert jax_provision_pretrained.main([str(h5), "--out", str(ref)]) == 0
    ref_report = json.loads(capsys.readouterr().out)
    assert port_report["family"] == family
    assert port_report == {**ref_report, "converted_to": str(port)}
    for name in ("params.msgpack", "meta.json"):
        assert (port / name).read_bytes() == (ref / name).read_bytes(), name
    assert provision_pretrained.main([str(h5)]) == 0
    assert "converted_to" not in json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("family", list(BACKBONES))
def test_encoder_loaders_and_family_check_match_jax(backbones, tmp_path, capsys, family):
    """``load_into_*_seg`` over the same variables, and a converted encoder
    refused by an architecture of another family."""
    import importlib

    from page_segmentation_tpu_torch.models.h5_import import load_encoder_into
    from page_segmentation_tpu_torch.models.registry import Architecture

    h5 = str(backbones(family))
    module, fn = {"mobilenet": ("mobilenet_import", "load_into_mobilenet_seg"),
                  "resnet": ("resnet_import", "load_into_resnet_seg"),
                  "effnet": ("efficientnet_import", "load_into_effnet_seg")}[family]
    variables = {"params": {"encoder": {"extra": np.ones(2, np.float32)},
                            "decoder": {"kernel": np.zeros((1, 2), np.float32)}},
                 "batch_stats": {}}
    got = getattr(importlib.import_module(f"page_segmentation_tpu_torch.models.{module}"), fn)(variables, h5)
    want = getattr(importlib.import_module(f"page_segmentation_tpu.models.{module}"), fn)(variables, h5)
    _same_tree(got, {k: dict(v) for k, v in want.items()})

    out = tmp_path / "enc"
    assert provision_pretrained.main([h5, "--out", str(out)]) == 0
    capsys.readouterr()
    with pytest.raises(ValueError, match=f"{family} backbone"):
        load_encoder_into({"params": {}}, Architecture(BACKBONES[family][2]), str(out))


def test_provision_refuses_a_file_of_no_known_family(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "other.h5"
    with h5py.File(path, "w") as f:
        f.attrs["layer_names"] = [b"dense"]
        group = f.create_group("dense")
        group.attrs["weight_names"] = [b"dense/kernel:0"]
        group.create_dataset("dense/kernel:0", data=np.zeros((2, 2), np.float32))
    with pytest.raises(SystemExit, match="unrecognized backbone"):
        provision_pretrained.main([str(path)])
    with pytest.raises(SystemExit, match="unrecognized backbone"):
        jax_provision_pretrained.main([str(path)])
