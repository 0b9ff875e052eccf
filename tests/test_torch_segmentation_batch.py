"""The port's PageSegmenter and ``page-segmentation`` command against the
JAX package's: XY-cut and text-contours modes, host and device morphology
backends (the device one on the CPU here), palette and RGB predictions.
Renders are compared as decoded labels and palettes (the PNG encoders
differ), PageXML byte for byte."""
import os

import numpy as np
import pytest
import torch

from page_segmentation_tpu.core import image_io as jax_io
from page_segmentation_tpu.core.colors import ColorMap as JaxColorMap
from page_segmentation_tpu.segmentation.batch import PageSegmenter as JaxPageSegmenter
from page_segmentation_tpu_torch.core import image_io
from page_segmentation_tpu_torch.core.colors import ColorMap
from page_segmentation_tpu_torch.segmentation.batch import PageSegmenter

SEG_MAP = {"(255, 255, 255)": (0, "background"), "(255, 0, 0)": (1, "text"),
           "(0, 255, 0)": (2, "image")}
SHAPES = [(300, 216), (333, 251), (280, 203), (310, 232), (297, 220)]  # widths: some % 8 != 0


def _labels(i: int, shape) -> np.ndarray:
    rng = np.random.default_rng(i)
    h, w = shape
    labels = np.zeros(shape, np.uint8)
    for row in range(15, h - 30, 22):
        labels[row : row + 11, int(rng.integers(0, 30)) : w - int(rng.integers(0, 40))] = 1
    labels[h // 2 : h // 2 + 60, w // 5 : w // 2] = 2
    labels[: h // 6, w - 15 :] = 1  # text at the right edge
    labels[rng.random(shape) < 0.005] = 1
    return labels


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """Palette PNGs (the predict stage's layout) and RGB PNGs of the same
    label maps."""
    root = tmp_path_factory.mktemp("predictions")
    palette = ColorMap(SEG_MAP).palette
    paths = {"indexed": [], "rgb": []}
    for i, shape in enumerate(SHAPES):
        labels = _labels(i, shape)
        for kind in paths:
            path = str(root / kind / f"p{i}.png")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            if kind == "indexed":
                image_io.imsave_indexed(path, labels, palette)
            else:
                image_io.imsave(path, palette[labels])
            paths[kind].append(path)
    return paths


def _assert_same_outputs(port_dir, jax_dir, port_xml, jax_xml, names):
    for name in names:
        got = image_io.imread_labels(os.path.join(port_dir, name + ".png"))
        want = jax_io.imread_labels(os.path.join(jax_dir, name + ".png"))
        assert got is not None and want is not None
        assert got[0].shape == want[0].shape and (got[0] == want[0]).all(), name
        assert (got[1] == want[1]).all(), name
        with open(os.path.join(port_xml, name + ".xml"), "rb") as f, \
                open(os.path.join(jax_xml, name + ".xml"), "rb") as g:
            assert f.read() == g.read(), name


def _run(cls, tmp, tag, pages, text_contours, backend, **kw):
    out, xml = str(tmp / f"{tag}_out"), str(tmp / f"{tag}_xml")
    cmap = (ColorMap if cls is PageSegmenter else JaxColorMap)(SEG_MAP)
    segmenter = cls(cmap, 300, text_contours, out, xml_output_dir=xml, backend=backend,
                    batch_size=2, **kw)
    results = list(segmenter.run(pages))
    return out, xml, results


@pytest.mark.parametrize("kind", ["indexed", "rgb"])
@pytest.mark.parametrize("text_contours", [False, True])
@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_page_segmenter_equals_the_jax_one(predictions, tmp_path, kind, text_contours, backend):
    """Both backends against the JAX host run; the device backend against
    the JAX device run too on pages whose width is a multiple of 8 (at other
    widths the JAX device module reads its row padding as page pixels)."""
    pages = [(p, ch) for p, ch in zip(predictions[kind], [9, 14, 14, 22, 9])]
    kw = {"device": "cpu"} if backend == "device" else {}
    out, xml, results = _run(PageSegmenter, tmp_path, "port", pages, text_contours, backend, **kw)
    jax_out, jax_xml, jax_results = _run(JaxPageSegmenter, tmp_path, "jax", pages,
                                         text_contours, "host")
    names = [f"p{i}" for i in range(len(pages))]
    _assert_same_outputs(out, jax_out, xml, jax_xml, names)
    assert [r[0] for r in results] == [r[0] for r in jax_results]
    if backend == "device" and text_contours:
        dev_out, dev_xml, _ = _run(JaxPageSegmenter, tmp_path, "jaxdev", pages, True, "device")
        aligned = [n for n, (h, w) in zip(names, SHAPES) if w % 8 == 0]
        assert aligned
        _assert_same_outputs(out, dev_out, xml, dev_xml, aligned)


@pytest.mark.parametrize("text_contours", [False, True])
def test_page_segmentation_cli_equals_the_jax_cli(predictions, tmp_path, text_contours):
    from page_segmentation_tpu.cli.main import main as jax_cli
    from page_segmentation_tpu_torch.cli.main import main as cli

    ColorMap(SEG_MAP).save(str(tmp_path / "map.json"))
    common = ["--prediction"] + predictions["indexed"] + ["--char_height", "14",
              "--color_map", str(tmp_path / "map.json"), "--seg_batch", "3"]
    common += ["--text_contours"] if text_contours else []
    runs = {"host": ["--morph_backend", "host"],
            "device": ["--morph_backend", "device", "--device", "cpu"]}
    for tag, extra in runs.items():
        assert cli(["page-segmentation", "--output_dir", str(tmp_path / f"{tag}_o"),
                    "--xml_output_dir", str(tmp_path / f"{tag}_x")] + common + extra) == 0
    assert jax_cli(["page-segmentation", "--output_dir", str(tmp_path / "jax_o"),
                    "--xml_output_dir", str(tmp_path / "jax_x")] + common) == 0
    names = [f"p{i}" for i in range(len(SHAPES))]
    for tag in runs:
        _assert_same_outputs(str(tmp_path / f"{tag}_o"), str(tmp_path / "jax_o"),
                             str(tmp_path / f"{tag}_x"), str(tmp_path / "jax_x"), names)
        for name in names:  # the two port backends write the same bytes
            for sub, ext in (("o", ".png"), ("x", ".xml")):
                with open(tmp_path / f"{tag}_{sub}" / (name + ext), "rb") as f, \
                        open(tmp_path / f"host_{sub}" / (name + ext), "rb") as g:
                    assert f.read() == g.read()


def test_the_device_backend_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    from page_segmentation_tpu_torch.cli.main import main as cli

    for text_contours in (False, True):
        with pytest.raises(RuntimeError, match="cuda"):
            PageSegmenter(ColorMap(SEG_MAP), 300, text_contours, str(tmp_path), backend="device")
    with pytest.raises(RuntimeError, match="cuda"):
        cli(["page-segmentation", "--prediction", "p.png", "--output_dir", str(tmp_path),
             "--char_height", "9", "--text_contours", "--morph_backend", "device"])
    with pytest.raises(ValueError, match="backend"):
        PageSegmenter(ColorMap(SEG_MAP), 300, True, str(tmp_path), backend="tpu")


def test_renders_in_other_formats_and_empty_runs(predictions, tmp_path):
    """A render in a format other than PNG (here BMP, through PIL) takes
    the palette image's RGB pixels; no pages, no output."""
    segmenter = PageSegmenter(ColorMap(SEG_MAP), 300, False, str(tmp_path / "o"), extension="bmp")
    list(segmenter.run([(predictions["rgb"][0], 14)]))
    jax_segmenter = JaxPageSegmenter(JaxColorMap(SEG_MAP), 300, False, str(tmp_path / "j"),
                                     extension="bmp")
    list(jax_segmenter.run([(predictions["rgb"][0], 14)]))
    got = jax_io.imread_rgb(str(tmp_path / "o" / "p0.bmp"))
    assert (got == jax_io.imread_rgb(str(tmp_path / "j" / "p0.bmp"))).all()
    assert list(segmenter.run([])) == []
