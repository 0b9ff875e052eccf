"""PageXML masks in the port (page_segmentation_tpu_torch.pagexml.mask_gen,
the ``gen-masks`` command) against the JAX package, which parses with lxml
and draws with PIL: the same pixels for the golden corpus in all five
settings, for seeded random polygons (concave, self-intersecting, collinear,
off the canvas, retracing their own edges, two points or fewer) and for
polylines of widths 1-9.
Pixels are compared, not files: the port's PNG encoder is not PIL's (PIL's
encoding of the port's golden-corpus masks is the frozen file)."""
import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from page_segmentation_tpu.core.image_io import imread_rgb as jax_imread_rgb
from page_segmentation_tpu.pagexml import mask_gen as jax_mask_gen
from page_segmentation_tpu_torch.core.image_io import imread_rgb
from page_segmentation_tpu_torch.pagexml import mask_gen

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS_XML = os.path.join(REPO, "tests", "golden_corpus", "xml")
SETTINGS = ["all_types", "text_nontext", "baseline", "textline", "text_only"]
N_POLYGONS = 64  # per kind, 6 kinds: 384 polygons


@pytest.mark.parametrize("setting", SETTINGS)
def test_gen_masks_cli_writes_the_jax_clis_pixels(setting, tmp_path):
    from page_segmentation_tpu.cli.main import main as jax_cli
    from page_segmentation_tpu_torch.cli.main import main as cli

    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    assert cli(["gen-masks", "--input_dir", CORPUS_XML, "--output_dir", str(port_dir),
                "--setting", setting]) == 0
    assert jax_cli(["gen-masks", "--input_dir", CORPUS_XML, "--output_dir", str(jax_dir),
                    "--setting", setting]) == 0
    names = sorted(os.listdir(jax_dir))
    assert sorted(os.listdir(port_dir)) == names and len(names) == 12
    with open(os.path.join(REPO, "tests", "golden_corpus", "frozen.json")) as f:
        frozen = json.load(f)["mask_sha256"][setting]
    for name in names:
        if name.endswith(".png"):
            got, want = imread_rgb(str(port_dir / name)), jax_imread_rgb(str(jax_dir / name))
            assert got.shape == want.shape and (got == want).all(), name
            # PIL's encoding of the port's pixels is the frozen file
            buf = io.BytesIO()
            Image.fromarray(got).save(buf, format="PNG")
            assert hashlib.sha256(buf.getvalue()).hexdigest() == frozen[name], name
    assert json.loads((port_dir / "image_map.json").read_text()) == \
        json.loads((jax_dir / "image_map.json").read_text())


def test_gen_masks_options(tmp_path):
    """--input globs, --threads, --use_xml_filename, --image_map_dir,
    --pcgts_version and --line_width as the JAX CLI takes them."""
    from page_segmentation_tpu.cli.main import main as jax_cli
    from page_segmentation_tpu_torch.cli.main import main as cli

    args = ["--input", os.path.join(CORPUS_XML, "page1*.xml"), "--setting", "baseline",
            "--threads", "3", "--use_xml_filename", "--pcgts_version", "2019", "--line_width", "8"]
    assert cli(["gen-masks", "--output_dir", str(tmp_path / "p"),
                "--image_map_dir", str(tmp_path / "pm")] + args) == 0
    assert jax_cli(["gen-masks", "--output_dir", str(tmp_path / "j"),
                    "--image_map_dir", str(tmp_path / "jm")] + args) == 0
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == ["page1.mask.png", "page10.mask.png"] == sorted(os.listdir(tmp_path / "p"))
    for name in names:
        assert (imread_rgb(str(tmp_path / "p" / name))
                == jax_imread_rgb(str(tmp_path / "j" / name))).all()
    assert (tmp_path / "pm" / "image_map.json").read_text() == \
        (tmp_path / "jm" / "image_map.json").read_text()


def _polygon(kind: str, rng, h: int, w: int) -> np.ndarray:
    n = int(rng.integers(3, 12))
    if kind == "concave":  # a star around a center: concave in most draws
        angles = np.sort(rng.uniform(0, 2 * np.pi, n))
        radii = rng.uniform(2, min(h, w) / 2, n)
        center = rng.uniform(0, [w, h])
        pts = np.stack([center[0] + radii * np.cos(angles), center[1] + radii * np.sin(angles)], 1)
        return np.round(pts).astype(int)
    if kind == "self_intersecting":
        return rng.integers(0, [w, h], (n, 2))
    if kind == "collinear":  # points on a coarse grid: runs along rows, columns, diagonals
        pts = rng.integers(0, 8, (n, 2)) * np.array([w // 8, h // 8])
        mid = (pts + np.roll(pts, -1, 0)) // 2  # a midpoint on every edge
        return np.stack([pts, mid], 1).reshape(-1, 2)
    if kind == "off_canvas":
        return rng.integers([-3 * w, -3 * h], [4 * w, 4 * h], (n, 2))
    if kind == "retracing":  # repeated vertices: edges that run back over themselves
        pts = rng.integers(0, [w, h], (n, 2))
        return pts[rng.integers(0, n, 2 * n)]
    return rng.integers(0, [w, h], (int(rng.integers(0, 3)), 2))  # two points or fewer


def _page(polygons, h, w, names):
    return (mask_gen.PageRegions((h, w), [mask_gen.Region([tuple(map(int, p)) for p in pts],
                                                          mask_gen.PageXMLTypes(t))
                                          for pts, t in zip(polygons, names)], "x.png"),
            jax_mask_gen.PageRegions((h, w), [jax_mask_gen.Region([tuple(map(int, p)) for p in pts],
                                                                  jax_mask_gen.PageXMLTypes(t))
                                              for pts, t in zip(polygons, names)], "x.png"))


def _masks(port_page, jax_page, mask_type: str, **kw):
    setting = mask_gen.MaskSetting(mask_type=mask_gen.MaskType(mask_type), **kw)
    jax_setting = jax_mask_gen.MaskSetting(mask_type=jax_mask_gen.MaskType(mask_type), **kw)
    return (mask_gen.page_region_to_mask(port_page, setting),
            np.asarray(jax_mask_gen.page_region_to_mask(jax_page, jax_setting)))


KINDS = ["concave", "self_intersecting", "collinear", "off_canvas", "retracing",
         "two_points_or_fewer"]


@pytest.mark.parametrize("kind", KINDS)
def test_random_polygons_fill_the_jax_packages_pixels(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    types = [t.value for t in mask_gen.PageXMLTypes]
    for _ in range(N_POLYGONS // 4):
        h, w = int(rng.integers(8, 90)), int(rng.integers(8, 90))
        polygons = [_polygon(kind, rng, h, w) for _ in range(4)]
        names = [types[i] for i in rng.integers(0, len(types), 4)]
        port_page, jax_page = _page(polygons, h, w, names)
        for mask_type in ("all_types", "text_nontext"):  # ≤ 2 points: skipped
            got, want = _masks(port_page, jax_page, mask_type)
            assert got.dtype == np.uint8 and got.shape == want.shape and (got == want).all()
        if kind != "two_points_or_fewer" or all(len(p) >= 2 for p in polygons):
            got, want = _masks(port_page, jax_page, "textline")  # ≤ 2 points: drawn
            assert (got == want).all()
            got = mask_gen.page_region_to_binary_mask(port_page)
            want = jax_mask_gen.page_region_to_binary_mask(jax_page)
            assert got.dtype == want.dtype == bool and (got == want).all()
        else:  # fewer than two points: both refuse the line mask alike
            with pytest.raises(TypeError, match="at least 2 coordinates") as port_err:
                _masks(port_page, jax_page, "textline")
            with pytest.raises(TypeError) as jax_err:
                jax_mask_gen.page_region_to_mask(jax_page, jax_mask_gen.MaskSetting(
                    mask_type=jax_mask_gen.MaskType.TEXT_LINE))
            assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("width", range(1, 10))
def test_polylines_stroke_the_jax_packages_pixels(width):
    rng = np.random.default_rng(100 + width)
    for trial in range(12):
        h, w = int(rng.integers(10, 80)), int(rng.integers(10, 80))
        n = int(rng.integers(0, 7))
        lines = [rng.integers(-10, [w + 10, h + 10], (n, 2)),  # any direction, off the canvas too
                 rng.integers(0, 6, (n, 2)) * np.array([w // 5, h // 5])]  # axis and diagonal runs
        port_page, jax_page = _page(lines, h, w, ["paragraph", "heading"])
        got, want = _masks(port_page, jax_page, "baseline", line_width=width)
        assert (got == want).all(), (width, trial)


@pytest.mark.parametrize("version", ["2019", "2017", "2013", "2010"])
def test_namespace_detection_and_prefixed_documents(version, tmp_path):
    ns = mask_gen.PCGTSVersion(version).get_namespace()
    doc = (f'<?xml version="1.0"?>\n<pc:PcGts xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance" '
           f'xmlns:pc="{ns}"><pc:Page imageFilename="img/p.png" imageHeight="30" imageWidth="20">'
           '<pc:TextRegion id="a" type="heading"><pc:Coords points="1,1 15,2 12,20"/>'
           '<pc:TextLine><pc:Coords points="2,2 9,2 9,6"/><pc:Baseline points="2,6 9,6"/></pc:TextLine>'
           '</pc:TextRegion><pc:GraphicRegion><pc:Coords points="0,25 19,25 19,29"/></pc:GraphicRegion>'
           '<pc:TextRegion id="b"/></pc:Page></pc:PcGts>')
    path = tmp_path / "p.xml"
    path.write_text(doc)
    for mask_type in SETTINGS:
        setting = mask_gen.MaskSetting(mask_type=mask_gen.MaskType(mask_type))
        jax_setting = jax_mask_gen.MaskSetting(mask_type=jax_mask_gen.MaskType(mask_type))
        page = mask_gen.get_xml_regions(str(path), setting)
        jax_page = jax_mask_gen.get_xml_regions(str(path), jax_setting)
        assert page.image_size == jax_page.image_size and page.filename == jax_page.filename
        assert [(r.polygon, r.type.value) for r in page.xml_regions] == \
            [(r.polygon, r.type.value) for r in jax_page.xml_regions]
        assert (mask_gen.page_region_to_mask(page, setting)
                == np.asarray(jax_mask_gen.page_region_to_mask(jax_page, jax_setting))).all()
    out = mask_gen.MaskGenerator(mask_gen.MaskSetting()).save(str(path), str(tmp_path / "o"))
    assert out == str(tmp_path / "o" / "p.mask.png")


@pytest.mark.parametrize("uri, message", [
    ("http://schema.primaresearch.org/PAGE/gts/pagecontent/2099-01-01", "Unknown Schema Version"),
    ("http://example.org/other", "No PAGE namespace found"),
])
def test_unknown_namespaces_raise_as_in_the_jax_package(uri, message, tmp_path):
    path = tmp_path / "p.xml"
    path.write_text(f'<PcGts xmlns="{uri}"><Page imageHeight="2" imageWidth="2" '
                    'imageFilename="p.png"/></PcGts>')
    with pytest.raises(Exception, match=message):
        mask_gen.get_xml_regions(str(path), mask_gen.MaskSetting())
    with pytest.raises(Exception, match=message):
        jax_mask_gen.get_xml_regions(str(path), jax_mask_gen.MaskSetting())


def test_tables_equal_the_jax_packages():
    assert [(t.name, t.value, t.color) for t in mask_gen.PageXMLTypes] == \
        [(t.name, t.value, t.color) for t in jax_mask_gen.PageXMLTypes]
    for mask_type in SETTINGS:
        assert mask_gen.PageXMLTypes.image_map(mask_gen.MaskType(mask_type)) == \
            jax_mask_gen.PageXMLTypes.image_map(jax_mask_gen.MaskType(mask_type))
        for t in mask_gen.PageXMLTypes:
            for capital in (False, True):
                region = mask_gen.Region([], t)
                jax_region = jax_mask_gen.Region([], jax_mask_gen.PageXMLTypes(t.value))
                assert mask_gen.MaskType(mask_type).get_color(region, capital) == \
                    jax_mask_gen.MaskType(mask_type).get_color(jax_region, capital)
    for points in (None, "", "1,2", "1,2 30,-4 5,6"):
        assert mask_gen.string_to_lp(points) == jax_mask_gen.string_to_lp(points)
