"""PageXML ground truth -> color mask images (the ``gen-masks`` command).

Counterpart of the JAX package's ``pagexml.mask_gen``: ``MaskType``,
``PCGTSVersion`` with namespace detection, ``MaskSetting``, the 19 PAGE
region types of ``PageXMLTypes`` with their fixed RGB colors, and
``MaskGenerator``.  Each mask type harvests regions by a list of
(path, coords tag, type) rules.  Files are parsed with
``xml.etree.ElementTree``; polygons and baselines are drawn by the port's
native rasterizer (``native.fill_polygon`` / ``native.draw_lines``), which
draws PIL ``ImageDraw``'s pixels, and masks are written with the port's
PNG encoder.  Nothing here needs lxml or PIL.
"""
from __future__ import annotations

import enum
import os
import xml.etree.ElementTree as ET
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from .. import native
from ..core.image_io import imsave

_PAGE_NAMESPACE_PREFIX = "http://schema.primaresearch.org/PAGE/gts/pagecontent"


class MaskType(enum.Enum):
    ALLTYPES = "all_types"
    TEXT_GRAPHICS = "text_nontext"
    BASE_LINE = "baseline"
    TEXT_LINE = "textline"
    TEXT_ONLY = "text_only"

    def get_color(self, region: "Region", capital_is_text: bool) -> Tuple[int, int, int]:
        if self is MaskType.ALLTYPES:
            return region.type.color
        if self is MaskType.TEXT_ONLY:
            return region.type.color_text_only(capital_is_text)
        return region.type.color_text_graphics(capital_is_text)


class PCGTSVersion(enum.Enum):
    PCGTS2019 = "2019"
    PCGTS2017 = "2017"
    PCGTS2013 = "2013"
    PCGTS2010 = "2010"

    def get_namespace(self) -> str:
        return {
            PCGTSVersion.PCGTS2019: _PAGE_NAMESPACE_PREFIX + "/2019-07-15",
            PCGTSVersion.PCGTS2017: _PAGE_NAMESPACE_PREFIX + "/2017-07-15",
            PCGTSVersion.PCGTS2013: _PAGE_NAMESPACE_PREFIX + "/2013-07-15",
            PCGTSVersion.PCGTS2010: _PAGE_NAMESPACE_PREFIX + "/2010-03-19",
        }[self]

    @staticmethod
    def detect(namespaces) -> "PCGTSVersion":
        """The version of the first PAGE namespace among ``namespaces``,
        the URIs declared on a document's root element."""
        for ns in namespaces:
            if ns.startswith(_PAGE_NAMESPACE_PREFIX):
                for version in PCGTSVersion:
                    if version.get_namespace() == ns:
                        return version
                raise Exception("Unknown Schema Version")
        raise Exception("No PAGE namespace found")


class MaskSetting(NamedTuple):
    mask_extension: str = "png"
    mask_type: MaskType = MaskType.ALLTYPES
    pcgts_version: Optional[PCGTSVersion] = None  # detected when not given
    line_width: int = 5
    capital_is_text: bool = False
    use_xml_filename: bool = False


class PageXMLTypes(enum.Enum):
    PARAGRAPH = ("paragraph", (255, 0, 0))
    IMAGE = ("ImageRegion", (0, 255, 0))
    GRAPHIC = ("GraphicRegion", (0, 255, 0))
    TABLE = ("TableRegion", (0, 128, 0))
    MATHS = ("MathsRegion", (0, 0, 128))
    HEADING = ("heading", (0, 0, 255))
    HEADER = ("header", (0, 255, 255))
    CATCH_WORD = ("catch-word", (255, 255, 0))
    PAGE_NUMBER = ("page-number", (255, 0, 255))
    SIGNATURE_MARK = ("signature-mark", (128, 0, 128))
    MARGINALIA = ("marginalia", (128, 128, 0))
    OTHER = ("other", (0, 128, 128))
    DROP_CAPITAL = ("drop-capital", (255, 128, 0))
    FLOATING = ("floating", (255, 0, 128))
    CAPTION = ("caption", (128, 255, 0))
    ENDNOTE = ("endnote", (0, 255, 128))
    FOOTER = ("footer", (255, 128, 128))
    FOOTNOTE = ("footnote", (128, 255, 128))
    FOOTNOTE_CONTINUED = ("footnote-continued", (128, 255, 128))
    UNKNOWN = ("", (10, 10, 10))

    def __new__(cls, value, color):
        obj = object.__new__(cls)
        obj._value_ = value
        obj.color = color
        obj.label = value
        return obj

    def color_text_graphics(self, capital_is_text: bool = False) -> Tuple[int, int, int]:
        return (255, 0, 0) if self.is_text(capital_is_text) else (0, 255, 0)

    def color_text_only(self, capital_is_text: bool = False) -> Tuple[int, int, int]:
        return (255, 0, 0) if self.is_text(capital_is_text) else (255, 255, 255)

    def is_text(self, capital_is_text: bool) -> bool:
        return not (
            self is PageXMLTypes.IMAGE
            or self is PageXMLTypes.GRAPHIC
            or (self is PageXMLTypes.DROP_CAPITAL and not capital_is_text)
        )

    @classmethod
    def image_map(cls, mask_type: MaskType) -> dict:
        """The ``"(r, g, b)" -> (index, label)`` mapping of a mask type, as
        ``ColorMap`` takes it."""
        types = {
            MaskType.ALLTYPES: list(PageXMLTypes),
            MaskType.TEXT_GRAPHICS: [PageXMLTypes.PARAGRAPH, PageXMLTypes.IMAGE],
            MaskType.TEXT_ONLY: [PageXMLTypes.PARAGRAPH],
            MaskType.TEXT_LINE: [PageXMLTypes.PARAGRAPH],
            MaskType.BASE_LINE: [PageXMLTypes.PARAGRAPH],
        }[mask_type]
        mapping = {str(t.color): (i + 1, t.label) for i, t in enumerate(types)}
        mapping["(255, 255, 255)"] = (0, "background")
        return mapping


class Region(NamedTuple):
    polygon: List[Tuple[int, int]]
    type: PageXMLTypes


class PageRegions(NamedTuple):
    image_size: Tuple[int, int]
    xml_regions: List[Region]
    filename: str


class MaskGenerator:
    def __init__(self, settings: MaskSetting):
        self.settings = settings

    def save(self, file, output_dir) -> str:
        """Draw one PageXML file into ``<page>.mask.<ext>``; returns its path."""
        page = get_xml_regions(file, self.settings)
        name_source = file if self.settings.use_xml_filename else page.filename
        page_name = os.path.splitext(os.path.basename(name_source))[0]
        os.makedirs(output_dir, exist_ok=True)
        out = os.path.join(output_dir, f"{page_name}.mask.{self.settings.mask_extension}")
        imsave(out, page_region_to_mask(page, self.settings))
        return out


def string_to_lp(points: Optional[str]) -> List[Tuple[int, int]]:
    """A PageXML points attribute ('x0,y0 x1,y1 ...') as integer tuples."""
    if not points:
        return []
    return [tuple(int(v) for v in pair.split(",")) for pair in points.split(" ")]


class _Harvest(NamedTuple):
    """One region rule: which elements, where their points are, and their
    type (None: the element's ``type`` attribute)."""

    path: str
    coords_tag: str = "pcgts:Coords"
    fixed_type: Optional[PageXMLTypes] = None


_MASK_HARVESTS = {
    # region masks read TextRegion outlines typed by their @type; all_types
    # adds maths and table regions, and both graphic tags take the image color
    MaskType.ALLTYPES: [
        _Harvest(".//pcgts:TextRegion"),
        _Harvest(".//pcgts:MathsRegion", fixed_type=PageXMLTypes.MATHS),
        _Harvest(".//pcgts:TableRegion", fixed_type=PageXMLTypes.TABLE),
        _Harvest(".//pcgts:ImageRegion", fixed_type=PageXMLTypes.IMAGE),
        _Harvest(".//pcgts:GraphicRegion", fixed_type=PageXMLTypes.IMAGE),
    ],
    MaskType.TEXT_GRAPHICS: [
        _Harvest(".//pcgts:TextRegion"),
        _Harvest(".//pcgts:ImageRegion", fixed_type=PageXMLTypes.IMAGE),
        _Harvest(".//pcgts:GraphicRegion", fixed_type=PageXMLTypes.IMAGE),
    ],
    MaskType.TEXT_ONLY: [_Harvest(".//pcgts:TextRegion")],
    # line masks read the TextLine children instead
    MaskType.TEXT_LINE: [_Harvest(".//pcgts:TextRegion/pcgts:TextLine")],
    MaskType.BASE_LINE: [
        _Harvest(".//pcgts:TextRegion/pcgts:TextLine", coords_tag="pcgts:Baseline")
    ],
}


def _element_type(element) -> PageXMLTypes:
    return PageXMLTypes(element.attrib.get("type", "paragraph"))


def _harvest_regions(root, namespaces, rules: List[_Harvest]) -> List[Region]:
    regions: List[Region] = []
    for rule in rules:
        for element in root.findall(rule.path, namespaces):
            coords = element.find(rule.coords_tag, namespaces)
            if coords is None:
                continue
            regions.append(Region(polygon=string_to_lp(coords.get("points")),
                                  type=rule.fixed_type or _element_type(element)))
    return regions


def _parse(xml_file):
    """(root element, URIs declared on the root) of a PageXML file."""
    declared, root = [], None
    for event, item in ET.iterparse(xml_file, events=("start-ns", "start")):
        if event == "start-ns":
            if root is None:
                declared.append(item[1])
        elif root is None:
            root = item
    return root, declared


def get_xml_regions(xml_file, setting: MaskSetting) -> PageRegions:
    """The regions a mask type needs, from one PageXML file."""
    root, declared = _parse(xml_file)
    version = setting.pcgts_version or PCGTSVersion.detect(declared)
    namespaces = {"pcgts": version.get_namespace()}
    regions = _harvest_regions(root, namespaces, _MASK_HARVESTS[setting.mask_type])
    page = root.find(".//pcgts:Page", namespaces)
    return PageRegions(
        image_size=(int(page.get("imageHeight")), int(page.get("imageWidth"))),
        xml_regions=regions,
        filename=resolve_relative_path(xml_file, page.get("imageFilename")),
    )


def resolve_relative_path(base, path) -> str:
    """``path`` resolved against ``base`` (a file resolves against its
    directory); absolute paths pass through."""
    if os.path.isabs(path):
        return path
    anchor = os.path.dirname(base) if os.path.isfile(base) else base
    return os.path.normpath(os.path.join(anchor, path))


def _fill(canvas: np.ndarray, polygon, color) -> None:
    """PIL's ``draw.polygon(polygon, outline=color, fill=color)``, which
    refuses fewer than two points with the same TypeError."""
    if len(polygon) < 2:
        raise TypeError("coordinate list must contain at least 2 coordinates")
    native.fill_polygon(canvas, polygon, color)


def page_region_to_binary_mask(page_region: PageRegions) -> np.ndarray:
    """(H, W) bool mask of every region's filled polygon."""
    height, width = page_region.image_size
    canvas = np.zeros((height, width), np.uint8)
    for region in page_region.xml_regions:
        _fill(canvas, region.polygon, 1)
    return canvas.view(bool)


def page_region_to_mask(page_region: PageRegions, setting: MaskSetting) -> np.ndarray:
    """(H, W, 3) uint8 color mask of one page on white: filled polygons for
    region and line masks, stroked polylines for baselines.  Region outlines
    of two or fewer points are skipped, except in line masks."""
    height, width = page_region.image_size
    canvas = np.full((height, width, 3), 255, np.uint8)
    for region in page_region.xml_regions:
        color = setting.mask_type.get_color(region, setting.capital_is_text)
        if setting.mask_type is MaskType.BASE_LINE:
            native.draw_lines(canvas, region.polygon, color, setting.line_width)
        elif setting.mask_type is MaskType.TEXT_LINE or len(region.polygon) > 2:
            _fill(canvas, region.polygon, color)
    return canvas
