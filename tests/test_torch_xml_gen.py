"""PageXML output in the port (page_segmentation_tpu_torch.pagexml.xml_gen,
its own serializer) against the JAX package's lxml output, byte for byte,
and the round trip xml_gen -> mask_gen."""
import numpy as np
import pytest

from page_segmentation_tpu.pagexml import mask_gen as jax_mask_gen
from page_segmentation_tpu.pagexml import xml_gen as jax_xml_gen
from page_segmentation_tpu.segmentation import xycut as jax_xycut
from page_segmentation_tpu_torch.pagexml import mask_gen, xml_gen
from page_segmentation_tpu_torch.segmentation import xycut

VERSIONS = ["2019", "2017", "2013", "2010"]


def _regions(seed: int, kind: str):
    """(port regions, JAX regions) of one kind, from a seed."""
    rng = np.random.default_rng(seed)
    if kind == "rect":
        boxes = [tuple(int(v) for v in rng.integers(0, 500, 4)) for _ in range(5)]
        return ([xycut.RectSegment(*b) for b in boxes], [jax_xycut.RectSegment(*b) for b in boxes])
    contours = [rng.integers(0, 900, (int(rng.integers(3, 30)), 2)).astype(np.int32)
                for _ in range(5)]
    return ([xycut.CVContour(c) for c in contours], [jax_xycut.CVContour(c) for c in contours])


@pytest.mark.parametrize("version", VERSIONS)
@pytest.mark.parametrize("kind", ["rect", "contour"])
def test_documents_are_byte_equal(version, kind):
    texts, jax_texts = _regions(1, kind)
    images, jax_images = _regions(2, "rect")
    extra, jax_extra = _regions(3, kind)
    got = xml_gen.build_pagexml(
        "page 1.png", (3508, 2480), texts, images,
        [("TableRegion", "table", extra[0]), ("MathsRegion", None, extra[1])],
        version=mask_gen.PCGTSVersion(version))
    want = jax_xml_gen.build_pagexml(
        "page 1.png", (3508, 2480), jax_texts, jax_images,
        [("TableRegion", "table", jax_extra[0]), ("MathsRegion", None, jax_extra[1])],
        version=jax_mask_gen.PCGTSVersion(version))
    assert got == want


@pytest.mark.parametrize("text", [
    "plain", "", "a&b<c>d\"e'f", "tab\there", "line\nbreak\r\nreturn", "é ü ß 漢字 \U0001F600",
    "\x7f\x85 ", "&amp; already escaped",
])
def test_escaping_is_byte_equal(text):
    kw = dict(creator=text, created=text)
    assert xml_gen.build_pagexml(text + ".png", (4, 3), **kw) == \
        jax_xml_gen.build_pagexml(text + ".png", (4, 3), **kw)
    rect, jax_rect = _regions(0, "rect")
    assert xml_gen.build_pagexml("p.png", (7, 9), extra_regions=[("TextRegion", text, rect[0])]) == \
        jax_xml_gen.build_pagexml("p.png", (7, 9), extra_regions=[("TextRegion", text, jax_rect[0])])


@pytest.mark.parametrize("bad", ["\x00", "\x01", "\x1f", "￾"])
def test_characters_xml_cannot_hold_are_refused_alike(bad):
    with pytest.raises(ValueError, match="XML compatible"):
        xml_gen.build_pagexml("p.png", (4, 3), creator="x" + bad)
    with pytest.raises(ValueError, match="XML compatible"):
        jax_xml_gen.build_pagexml("p.png", (4, 3), creator="x" + bad)


def test_default_document_and_save(tmp_path):
    assert xml_gen.build_pagexml("p.png", (10, 20)) == jax_xml_gen.build_pagexml("p.png", (10, 20))
    path = xml_gen.save_pagexml(str(tmp_path / "p.xml"), "p.png", (10, 20))
    assert open(path, "rb").read() == jax_xml_gen.build_pagexml("p.png", (10, 20))


@pytest.mark.parametrize("version", VERSIONS)
def test_round_trip_through_the_mask_reader(version, tmp_path):
    """xml_gen -> mask_gen gives back the regions: text contours as
    paragraphs, images as image regions; the JAX reader reads the same."""
    texts, _ = _regions(4, "contour")
    images, _ = _regions(5, "rect")
    path = str(tmp_path / "p.xml")
    xml_gen.save_pagexml(path, "p.png", (1000, 900), texts, images,
                         version=mask_gen.PCGTSVersion(version))
    setting = mask_gen.MaskSetting(mask_type=mask_gen.MaskType.ALLTYPES)
    page = mask_gen.get_xml_regions(path, setting)
    assert page.image_size == (1000, 900) and page.filename == str(tmp_path / "p.png")
    want = ([[tuple(p) for p in t.contour.tolist()] for t in texts]
            + [[(r.y_start, r.x_start), (r.y_end, r.x_start), (r.y_end, r.x_end),
                (r.y_start, r.x_end)] for r in images])
    assert [r.polygon for r in page.xml_regions] == want
    assert [r.type for r in page.xml_regions] == \
        [mask_gen.PageXMLTypes.PARAGRAPH] * 5 + [mask_gen.PageXMLTypes.IMAGE] * 5
    jax_page = jax_mask_gen.get_xml_regions(path, jax_mask_gen.MaskSetting())
    assert [r.polygon for r in jax_page.xml_regions] == want
    assert (mask_gen.page_region_to_mask(page, setting) ==
            np.asarray(jax_mask_gen.page_region_to_mask(jax_page, jax_mask_gen.MaskSetting()))).all()
