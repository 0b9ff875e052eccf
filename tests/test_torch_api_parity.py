"""The JAX package's public functions that the port gained last, against
the JAX package on the same inputs, on the CPU: ``ColorMap``'s members, the
RGB region renders, ``RectSegment.of``/``as_xy`` and ``single_color``,
``pc_segmentation``'s helpers, the gray PNG writers, the bucket study,
``PageRegions.only_types``, ``PCGTSVersion.detect`` on an lxml root,
``network_for_model``, a fresh FCNSkip's and FCN's weights (flax's draw),
``native.available``, the ``mask_bool`` keyword,
``per_leaf_norm_clip``, ``json_like``, ``relu`` and
``cc_min_label_xla_batch``; and a name-by-name comparison of the two
packages.

Tolerances: bytes, integers, labels and dicts are exactly equal; float32
logits agree to 1e-4 (the two frameworks sum convolutions in another
order), the clipped gradients to 1e-6 relative."""
import ast
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from page_segmentation_tpu import native as jax_native
from page_segmentation_tpu.core import colors as jax_colors
from page_segmentation_tpu.core import image_io as jax_io
from page_segmentation_tpu.data.dataset import SingleData as JaxSingleData
from page_segmentation_tpu.inference import classifier as jax_classifier
from page_segmentation_tpu.models import h5_import as jax_h5
from page_segmentation_tpu.models import layers as jax_layers
from page_segmentation_tpu.models import registry as jax_registry
from page_segmentation_tpu.ops import pad as jax_pad
from page_segmentation_tpu.ops import contours as jax_contours
from page_segmentation_tpu.ops import pallas_cc as jax_cc
from page_segmentation_tpu.pagexml import mask_gen as jax_mask_gen
from page_segmentation_tpu.segmentation import device_morph as jax_morph
from page_segmentation_tpu.segmentation import pc_segmentation as jax_pcs
from page_segmentation_tpu.segmentation import render as jax_render
from page_segmentation_tpu.segmentation import xycut as jax_xycut
from page_segmentation_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from page_segmentation_tpu_torch import native
from page_segmentation_tpu_torch.core import colors, image_io
from page_segmentation_tpu_torch.data.dataset import SingleData
from page_segmentation_tpu_torch.inference import classifier
from page_segmentation_tpu_torch.models import h5_import, layers
from page_segmentation_tpu_torch.models.bridge import init_params_numpy
from page_segmentation_tpu_torch.ops import contours, cuda_cc, pad
from page_segmentation_tpu_torch.pagexml import mask_gen
from page_segmentation_tpu_torch.segmentation import device_morph, pc_segmentation, render, xycut
from page_segmentation_tpu_torch.train import optim

REPO = Path(__file__).resolve().parents[1]
CORPUS = REPO / "tests" / "golden_corpus"


# ------------------------------------------------------------------ ColorMap
def _maps(package):
    """Color maps in every form a caller builds: tuple keys, string keys,
    several colors for one label and index (gen-masks' all_types map)."""
    return {
        "default": package.DEFAULT_IMAGE_MAP,
        "strings": package.ColorMap({"(255, 255, 255)": (0, "background"), "[0, 0, 255]": (2, "image"),
                                     "255 0 0": (1, "text")}),
        "all_types": package.ColorMap(
            jax_mask_gen.PageXMLTypes.image_map(jax_mask_gen.MaskType.ALLTYPES)),
    }


def _color_queries(m):
    keys = list(m.mapping)
    return keys, [str(k) for k in keys] + [(1, 2, 3), "(9, 9, 9)"]


@pytest.mark.parametrize("name", ["default", "strings", "all_types"])
@pytest.mark.parametrize("member", ["__contains__", "__eq__", "__repr__", "mapping", "labels",
                                    "color_for_index", "label_for_index"])
def test_color_map_members_match_jax(name, member):
    port, ref = _maps(colors)[name], _maps(jax_colors)[name]
    keys, queries = _color_queries(ref)
    indices = sorted({index for index, _ in ref.mapping.values()})
    if member == "__contains__":
        assert [q in port for q in keys + queries] == [q in ref for q in keys + queries]
    elif member == "__eq__":
        others = _maps(colors)
        ref_others = _maps(jax_colors)
        assert [port == o for o in others.values()] == [ref == o for o in ref_others.values()]
        assert port == colors.ColorMap(ref.mapping) and port != ref and port != "map"
    elif member == "__repr__":
        assert repr(port) == repr(ref)
    elif member == "mapping":
        assert port.mapping == ref.mapping and port.mapping is not port.mapping
    elif member == "labels":
        assert port.labels == ref.labels
    elif member == "color_for_index":
        assert [port.color_for_index(i) for i in indices] == [ref.color_for_index(i) for i in indices]
    else:
        assert [port.label_for_index(i) for i in indices] == [ref.label_for_index(i) for i in indices]


# ------------------------------------------------------- renders and regions
def _rects(package, seed, n=6, h=60, w=80):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x0, y0 = int(rng.integers(-10, h)), int(rng.integers(-10, w))
        out.append(package.RectSegment(x0, y0, x0 + int(rng.integers(0, 30)),
                                       y0 + int(rng.integers(0, 30))))
    return out


def _contours(package, contours_module, seed):
    """Boundary-traced contours of random blobs, the polygons the
    segmentation draws."""
    from scipy import ndimage as ndi

    blobs = ndi.binary_dilation(np.random.default_rng(seed).random((64, 72)) < 0.02, iterations=4)
    return [package.CVContour(c) for c in contours_module.find_external_contours(blobs.astype(np.uint8))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_rect_segments_match_jax(seed):
    groups = [((255, 0, 0), 0), ((0, 255, 0), 1), ((10, 20, 30), 2)]
    got = render.render_rect_segments(
        (80, 60), [(c, _rects(xycut, seed * 10 + k)) for c, k in groups], base_color=(1, 2, 3))
    want = jax_render.render_rect_segments(
        (80, 60), [(c, _rects(jax_xycut, seed * 10 + k)) for c, k in groups], base_color=(1, 2, 3))
    assert got.dtype == np.uint8 and got.shape == (60, 80, 3)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(render.render_rect_segments((80, 60), []),
                                  np.asarray(jax_render.render_rect_segments((80, 60), [])))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alias", ["render_contours", "render_ocv_contours"])
def test_render_contours_match_jax(seed, alias):
    from PIL import Image

    base = np.random.default_rng(seed).integers(0, 256, (64, 72, 3)).astype(np.uint8)
    got = getattr(render, alias)(base, _contours(xycut, contours, seed), (0, 0, 255))
    want = getattr(jax_render, alias)(Image.fromarray(base), _contours(jax_xycut, jax_contours, seed),
                                      (0, 0, 255))
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (base != got).any() and got is not base


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rect_segment_of_and_as_xy_match_jax(seed):
    image = np.arange(60 * 80 * 3).reshape(60, 80, 3)
    for got, want in zip(_rects(xycut, seed), _rects(jax_xycut, seed)):
        assert got.as_xy() == want.as_xy()
        np.testing.assert_array_equal(got.of(image), want.of(image))
        assert pc_segmentation.seg(*got.as_xy()) == xycut.RectSegment(
            *jax_pcs.seg(*want.as_xy()).__dict__.values())


@pytest.mark.parametrize("channels", [0, 3])
def test_single_color_matches_jax(channels):
    rng = np.random.default_rng(channels)
    shape = (40, 30, channels) if channels else (40, 30)
    image = rng.integers(0, 2, shape).astype(np.uint8) * 255
    for color in ([255, 0, 255] if channels else 255, np.array([0, 0, 0]) if channels else 0):
        np.testing.assert_array_equal(xycut.single_color(image, color),
                                      jax_xycut.single_color(image, color))


def test_pc_segmentation_color_mapping_matches_jax():
    assert pc_segmentation.ColorMapping == jax_pcs.ColorMapping
    assert pc_segmentation.DEFAULT_COLOR_MAPPING.keys() == jax_pcs.DEFAULT_COLOR_MAPPING.keys()
    for k, v in jax_pcs.DEFAULT_COLOR_MAPPING.items():
        np.testing.assert_array_equal(pc_segmentation.DEFAULT_COLOR_MAPPING[k], v)


# ------------------------------------------------------------------ writers
def _image(kind, shape, seed=4):
    rng = np.random.default_rng(seed)
    return {"gray": lambda: rng.integers(0, 256, shape).astype(np.uint8),
            "flat": lambda: (rng.integers(0, 4, shape) * 85).astype(np.uint8),
            "bool": lambda: rng.random(shape) < 0.3,
            "float": lambda: rng.uniform(-20, 300, shape),
            "rgb": lambda: rng.integers(0, 256, shape + (3,)).astype(np.uint8),
            "rgb_flat": lambda: (rng.integers(0, 3, shape + (3,)) * 127).astype(np.uint8),
            "rgb_mask": lambda: _mask(rng, shape)}[kind]()


def _mask(rng, shape):
    """A mask's rows: runs of equal rows, rows of zeros, first row zero."""
    mask = np.full(shape + (3,), 255, np.uint8)
    for _ in range(6):
        y, x = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        mask[y:y + rng.integers(1, 90), x:x + rng.integers(1, 30)] = rng.choice([0, 128, 255], 3)
    mask[:1] = 0
    mask[shape[0] // 2:shape[0] // 2 + 3] = 0
    return mask


@pytest.mark.parametrize("writer, args", [
    ("imsave_gray_fast", ()), ("imsave_gray_fast", (6,)), ("imsave_pil", ()),
])
@pytest.mark.parametrize("kind", ["gray", "flat", "bool", "float", "rgb", "rgb_flat", "rgb_mask"])
@pytest.mark.parametrize("shape", [(37, 53), (600, 41)])
def test_gray_writers_write_the_jax_bytes(tmp_path, writer, args, kind, shape):
    """Both writers give the JAX package's file bytes; ``imsave_pil``'s PNGs
    (PIL's bytes, its row filters over several of the port's row blocks)
    come without PIL."""
    image = _image(kind, shape)
    got, want = tmp_path / "port.png", tmp_path / "jax.png"
    if writer == "imsave_gray_fast" and kind.startswith("rgb"):
        for fn, path in ((image_io.imsave_gray_fast, got), (jax_io.imsave_gray_fast, want)):
            with pytest.raises(ValueError, match="grayscale"):
                fn(str(path), image)
        return
    getattr(image_io, writer)(str(got), image, *args)
    getattr(jax_io, writer)(str(want), image, *args)
    assert got.read_bytes() == want.read_bytes()


def test_encode_png_pil_splits_idat_as_pil_does(tmp_path):
    """An incompressible page spans several IDAT chunks of PIL's buffer
    size (64 KiB, or 4 bytes a column on wide pages)."""
    for shape in [(300, 260, 3), (40, 17000)]:
        image = np.random.default_rng(2).integers(0, 256, shape).astype(np.uint8)
        jax_io.imsave_pil(str(tmp_path / "jax.png"), image)
        assert image_io.encode_png_pil(image) == (tmp_path / "jax.png").read_bytes()
    with pytest.raises(ValueError, match="gray"):
        image_io.encode_png_pil(np.zeros((4, 4, 4), np.uint8))


def test_imsave_pil_needs_pil_only_beyond_gray_and_rgb_pngs(tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *args, **kwargs):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL here")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    image_io.imsave_pil(str(tmp_path / "x.png"), np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ImportError, match="imsave_pil needs PIL"):
        image_io.imsave_pil(str(tmp_path / "x.bmp"), np.zeros((4, 4), np.uint8))
    with pytest.raises(ImportError, match="imsave_pil needs PIL"):
        image_io.imsave_pil(str(tmp_path / "x.png"), np.zeros((4, 4, 4), np.uint8))


# ------------------------------------------------------------- bucketing
def _shapes(seed, n):
    rng = np.random.default_rng(seed)
    return [tuple(int(v) for v in rng.integers(200, 3600, 2)) for _ in range(n)]


@pytest.mark.parametrize("seed, n", [(0, 1), (1, 7), (2, 40), (3, 0)])
@pytest.mark.parametrize("factor", [8, 32])
def test_bucket_report_and_suggestion_match_jax(seed, n, factor):
    shapes = _shapes(seed, n)
    assert pad.bucket_report(shapes, factor) == jax_pad.bucket_report(shapes, factor)
    assert pad.bucket_report(shapes, factor, (1, 3, 16)) == jax_pad.bucket_report(shapes, factor, (1, 3, 16))
    for max_buckets in (1, 4, 8, 64):
        assert pad.suggest_granularity(shapes, factor, max_buckets) == \
            jax_pad.suggest_granularity(shapes, factor, max_buckets)


# ------------------------------------------------------------------ PageXML
@pytest.mark.parametrize("page", ["page0", "page4", "page10"])
@pytest.mark.parametrize("mask_type", ["ALLTYPES", "TEXT_GRAPHICS"])
def test_page_regions_only_types_match_jax(page, mask_type):
    xml = str(CORPUS / "xml" / f"{page}.xml")
    got = mask_gen.get_xml_regions(xml, mask_gen.MaskSetting(mask_type=mask_gen.MaskType[mask_type]))
    want = jax_mask_gen.get_xml_regions(
        xml, jax_mask_gen.MaskSetting(mask_type=jax_mask_gen.MaskType[mask_type]))
    for names in ([], ["PARAGRAPH"], ["IMAGE", "GRAPHIC"], ["PARAGRAPH", "HEADING", "IMAGE"]):
        g = got.only_types({mask_gen.PageXMLTypes[n] for n in names})
        w = want.only_types({jax_mask_gen.PageXMLTypes[n] for n in names})
        assert (g.image_size, g.filename) == (w.image_size, w.filename)
        assert [(r.polygon, r.type.name) for r in g.xml_regions] == \
            [(r.polygon, r.type.name) for r in w.xml_regions]
    assert got.only_types(set(mask_gen.PageXMLTypes)).xml_regions == got.xml_regions


@pytest.mark.parametrize("version", ["2019", "2017", "2013", "2010"])
def test_pcgts_version_detect_takes_an_lxml_root(version, tmp_path):
    from lxml import etree

    ns = jax_mask_gen.PCGTSVersion(version).get_namespace()
    path = tmp_path / "p.xml"
    path.write_text(f'<?xml version="1.0"?><pc:PcGts xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
                    f'xmlns:pc="{ns}"><pc:Page imageWidth="4" imageHeight="4"/></pc:PcGts>')
    root = etree.parse(str(path)).getroot()
    assert mask_gen.PCGTSVersion.detect(root).value == jax_mask_gen.PCGTSVersion.detect(root).value
    import xml.etree.ElementTree as ET

    assert mask_gen.PCGTSVersion.detect(ET.parse(str(path)).getroot()).value == version
    assert mask_gen.PCGTSVersion.detect(dict(root.nsmap)).value == version
    with pytest.raises(Exception, match="No PAGE namespace"):
        mask_gen.PCGTSVersion.detect({"x": "http://example.org/other"})


def test_page_xml_types_color_map_alias_matches_jax():
    for mask_type in mask_gen.MaskType:
        assert mask_gen.PageXMLTypes.color_map(mask_type) == \
            jax_mask_gen.PageXMLTypes.color_map(jax_mask_gen.MaskType(mask_type.value))
    assert len(mask_gen.PageXMLTypes) == len(jax_mask_gen.PageXMLTypes)


# ---------------------------------------------------------------- networks
def test_network_for_model_float32_logits_match_jax(tmp_path):
    path = str(tmp_path / "ckpt")
    jax_save_checkpoint(path, {"params": init_params_numpy(3, seed=11)}, {"architecture": "fcn_skip"})
    port = classifier.network_for_model(os.path.relpath(path), 3, device="cpu")
    ref = jax_classifier.network_for_model(os.path.relpath(path), 3)
    assert isinstance(port, classifier.PixelClassifier) and port.device.type == "cpu"
    image = np.random.default_rng(5).integers(0, 256, (72, 88)).astype(np.uint8)
    got = port.predict_single_data(SingleData(image=image))[0]
    want = ref.predict_single_data(JaxSingleData(image=image))[0]
    assert got.shape == want.shape and np.abs(got - want).max() <= 1e-4


def test_network_for_model_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    path = str(tmp_path / "ckpt")
    jax_save_checkpoint(path, {"params": init_params_numpy(3, seed=1)}, {"architecture": "fcn_skip"})
    with pytest.raises(RuntimeError, match="cuda"):
        classifier.network_for_model(path, 3)


@pytest.mark.parametrize("architecture, s2d", [("fcn_skip", False), ("fcn", False), ("fcn_skip", True)])
@pytest.mark.parametrize("seed", [0, 1, 7, 2**32 + 9, -3])
def test_fresh_fcn_weights_are_the_jax_packages(architecture, s2d, seed):
    """A fresh FCNSkip or FCN classifier (and so a fresh Trainer) starts
    from the JAX package's own initial weights, bit for bit."""
    from page_segmentation_tpu.models.registry import Architecture as JaxArchitecture
    from page_segmentation_tpu_torch.models.registry import Architecture

    want = jax_classifier.PixelClassifier(3, architecture=JaxArchitecture(architecture), seed=seed,
                                          s2d_stem=s2d).params
    got = classifier.PixelClassifier(3, architecture=Architecture(architecture), seed=seed,
                                     s2d_stem=s2d, device="cpu").params
    assert list(got) == list(want)
    for layer in want:
        assert got[layer].keys() == want[layer].keys()
        for leaf, value in want[layer].items():
            assert got[layer][leaf].dtype == np.float32
            assert got[layer][leaf].tobytes() == np.asarray(value).tobytes(), (layer, leaf)


def test_native_available_matches_jax():
    assert native.available() is jax_native.available() is True


@pytest.mark.parametrize("fn", ["dilate_box", "erode_box", "text_region_chain"])
def test_mask_bool_keyword_is_accepted(fn):
    masks = np.random.default_rng(7).random((2, 24, 32)) < 0.4
    kwargs = {"kernels": (5, 1, 4)} if fn == "text_region_chain" else {"kh": 3, "kw": 5}
    got = getattr(device_morph, fn)(mask_bool=torch.from_numpy(masks), **kwargs).numpy()
    want = np.asarray(getattr(jax_morph, fn)(mask_bool=jnp.asarray(masks), **kwargs))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_norm", [0.05, 1.0, 100.0])
def test_per_leaf_norm_clip_matches_jax(max_norm):
    rng = np.random.default_rng(8)
    grads = {k: rng.normal(size=s).astype(np.float32) for k, s in
             (("a", (3, 4)), ("b", (7,)), ("c", (2, 2, 5)))}
    got = optim.per_leaf_norm_clip(max_norm)({k: torch.from_numpy(v) for k, v in grads.items()})
    tx = jax_registry.per_leaf_norm_clip(max_norm)
    want, _ = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, tx.init(grads))
    for k in grads:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)


def test_json_like_and_relu_match_jax():
    tree = {"a": {"b": np.arange(3.0)}, "c": np.ones((2, 2))}
    got, want = h5_import.json_like(tree), jax_h5.json_like(tree)
    assert got.keys() == want.keys() and got["a"].keys() == want["a"].keys()
    assert got["a"]["b"] is tree["a"]["b"] and type(got["a"]) is dict
    x = np.linspace(-2, 2, 9, dtype=np.float32)
    np.testing.assert_array_equal(layers.relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_layers.relu(jnp.asarray(x))))


def test_cc_min_label_xla_batch_matches_jax():
    ink = np.random.default_rng(9).random((3, 20, 24)) < 0.45
    got, _ = cuda_cc.cc_min_label_xla_batch(ink, device="cpu")
    want, _ = jax_cc.cc_min_label_xla_batch(jnp.asarray(ink))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------ the whole surface
def _public_names(package_dir: Path):
    """{module path: names} of a package's top-level functions, classes,
    constants and class members, private names left out; plus the set of
    flax module fields and calls (of classes deriving from ``nn.Module``,
    also through a base of the package), which the port's torch modules
    hold as constructor arguments and ``forward``."""
    trees = {path.relative_to(package_dir).as_posix(): ast.parse(path.read_text())
             for path in package_dir.rglob("*.py")}
    bases = {node.name: [ast.unparse(b).split(".")[-1] for b in node.bases]
             for tree in trees.values() for node in tree.body if isinstance(node, ast.ClassDef)}

    def is_module(name, seen=()):
        return name == "Module" or any(b not in seen and is_module(b, seen + (name,))
                                       for b in bases.get(name, []))

    names, module_fields = {}, set()
    for module, tree in trees.items():
        found = set()
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                found.add(node.name)
            elif isinstance(node, ast.Assign):
                found.update(t.id for t in node.targets if isinstance(t, ast.Name))
            if not isinstance(node, ast.ClassDef):
                continue
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    member = sub.name
                elif isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    targets = sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                    member = next((t.id for t in targets if isinstance(t, ast.Name)), None)
                else:
                    continue
                if member is None:
                    continue
                found.add(f"{node.name}.{member}")
                if is_module(node.name) and (isinstance(sub, ast.AnnAssign) or member == "__call__"):
                    module_fields.add(f"{node.name}.{member}")
        names[module] = {n for n in found
                         if not any(p.startswith("_") and not p.endswith("__") for p in n.split("."))}
    return names, module_fields


def test_every_public_name_of_the_jax_package_has_a_port_counterpart():
    jax_names, module_fields = _public_names(REPO / "page_segmentation_tpu")
    port_names = set().union(*_public_names(REPO / "page_segmentation_tpu_torch")[0].values())
    missing = sorted(
        f"{module}: {name}" for module, found in jax_names.items() for name in found
        if name not in port_names and name not in module_fields
        and not name.endswith("_jax")  # the port's counterparts are the *_torch functions
    )
    assert not missing, missing
