"""Segmentation regions -> a PageXML document.

Counterpart of the JAX package's ``pagexml.xml_gen``: the XY-cut rectangles
and text contours of ``page-segmentation`` as a PageXML document (2019-07-15
schema by default) that OCR tools read.  The document is written by this
module's own serializer, byte for byte what lxml's ``etree.tostring(root,
xml_declaration=True, encoding="UTF-8", pretty_print=True)`` gives for it:
a single-quoted declaration, the default namespace declared on the root,
attributes in the order given, childless elements without text closed as
``<tag/>``, two-space indentation and a final newline, ``& < > " \\t \\n
\\r`` escaped in attributes and ``& < > \\r`` in text, characters outside
ASCII written as UTF-8, and characters XML cannot hold refused.  The
Metadata times are the caller's (a fixed placeholder by default), so that
documents compare equal from run to run.
"""
from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..segmentation.xycut import AnyRegion, RectSegment
from .mask_gen import PCGTSVersion

_PLACEHOLDER_TIME = "1970-01-01T00:00:00"
# the project's name, which the JAX package's documents carry as well
_CREATOR = __name__.split(".")[0].removesuffix("_torch")

_NOT_XML = re.compile("[\x00-\x08\x0b\x0c\x0e-\x1f￾￿]")
_ATTR_ESCAPES = {"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;",
                 "\t": "&#9;", "\n": "&#10;", "\r": "&#13;"}
_TEXT_ESCAPES = {"&": "&amp;", "<": "&lt;", ">": "&gt;", "\r": "&#13;"}
_ATTR_SPECIAL = re.compile('[&<>"\t\n\r]')
_TEXT_SPECIAL = re.compile("[&<>\r]")


def _checked(value: str) -> str:
    value = str(value)
    if _NOT_XML.search(value):
        raise ValueError("All strings must be XML compatible: Unicode or ASCII, "
                         "no NULL bytes or control characters")
    return value


def _attr(value) -> str:
    return _ATTR_SPECIAL.sub(lambda m: _ATTR_ESCAPES[m.group()], _checked(value))


def _text(value) -> str:
    return _TEXT_SPECIAL.sub(lambda m: _TEXT_ESCAPES[m.group()], _checked(value))


class _Element:
    def __init__(self, tag: str, attrs=(), text: Optional[str] = None):
        self.tag = tag
        self.attrs = [(k, _attr(v)) for k, v in attrs]
        self.text = None if text is None else _text(text)
        self.children: List["_Element"] = []

    def add(self, tag: str, attrs=(), text: Optional[str] = None) -> "_Element":
        child = _Element(tag, attrs, text)
        self.children.append(child)
        return child

    def write(self, out: List[str], depth: int) -> None:
        indent = "  " * depth
        head = "<" + self.tag + "".join(f' {k}="{v}"' for k, v in self.attrs)
        if self.children:
            out.append(f"{indent}{head}>\n")
            for child in self.children:
                child.write(out, depth + 1)
            out.append(f"{indent}</{self.tag}>\n")
        elif self.text is not None:
            out.append(f"{indent}{head}>{self.text}</{self.tag}>\n")
        else:
            out.append(f"{indent}{head}/>\n")


def _page_points(region: AnyRegion) -> str:
    """A region's outline as a PAGE points attribute, (x = column, y = row).
    Contours carry (column, row) points already; a RectSegment's x indexes
    rows, so it is transposed here."""
    if isinstance(region, RectSegment):
        polygon = [
            (region.y_start, region.x_start),
            (region.y_end, region.x_start),
            (region.y_end, region.x_end),
            (region.y_start, region.x_end),
        ]
    else:
        polygon = region.polygon_coords()
    return " ".join(f"{int(x)},{int(y)}" for x, y in np.asarray(polygon).reshape(-1, 2))


def build_pagexml(
    image_filename: str,
    image_size: Tuple[int, int],
    text_regions: Sequence[AnyRegion] = (),
    image_regions: Sequence[AnyRegion] = (),
    extra_regions: Iterable[Tuple[str, Optional[str], AnyRegion]] = (),
    creator: str = _CREATOR,
    created: str = _PLACEHOLDER_TIME,
    version: PCGTSVersion = PCGTSVersion.PCGTS2019,
) -> bytes:
    """A PageXML document (UTF-8 bytes) of the regions of one page.

    ``text_regions`` become ``TextRegion type="paragraph"``,
    ``image_regions`` ``ImageRegion``, and ``extra_regions`` entries
    ``(tag, type attribute or None, region)`` any other region element.
    ``image_size`` is (height, width).
    """
    root = _Element("PcGts", [("xmlns", version.get_namespace())])
    meta = root.add("Metadata")
    meta.add("Creator", text=creator)
    meta.add("Created", text=created)
    meta.add("LastChange", text=created)
    height, width = image_size
    page = root.add("Page", [("imageFilename", image_filename),
                             ("imageHeight", int(height)), ("imageWidth", int(width))])
    regions = ([("TextRegion", "paragraph", r) for r in text_regions]
               + [("ImageRegion", None, r) for r in image_regions] + list(extra_regions))
    for index, (tag, type_attr, region) in enumerate(regions):
        attrs = [("id", f"r{index}")] + ([("type", type_attr)] if type_attr else [])
        page.add(tag, attrs).add("Coords", [("points", _page_points(region))])
    out = ["<?xml version='1.0' encoding='UTF-8'?>\n"]
    root.write(out, 0)
    return "".join(out).encode("utf-8")


def save_pagexml(path: str, *args, **kwargs) -> str:
    """Write :func:`build_pagexml`'s document to ``path``; returns the path."""
    payload = build_pagexml(*args, **kwargs)
    with open(path, "wb") as f:
        f.write(payload)
    return path
