"""RGB <-> label codec: the part of ``ColorMap`` the predict, evaluate,
segmentation and mask-generation paths need, including the JSON "image
map" reader and writer (``--color_map``, ``image_map.json``), and
``exact_color_mask``.

The on-disk JSON form maps a stringified RGB tuple to ``[index, label]``::

    {"(255, 255, 255)": [0, "background"], "(255, 0, 0)": [1, "paragraph"]}
"""
from __future__ import annotations

import json
from typing import Dict, Mapping, Tuple, Union

import numpy as np

RGBColor = Tuple[int, int, int]
ColorKey = Union[str, RGBColor]


def _parse_color(key: ColorKey) -> RGBColor:
    if isinstance(key, str):
        parts = [p for p in key.strip().strip("()[]").replace(",", " ").split() if p]
        if len(parts) != 3:
            raise ValueError(f"Cannot parse color key {key!r}")
        return tuple(int(p) for p in parts)  # type: ignore[return-value]
    color = tuple(int(c) for c in key)
    if len(color) != 3:
        raise ValueError(f"Color must have 3 components, got {key!r}")
    return color  # type: ignore[return-value]


class ColorMap:
    """Mapping between RGB colors, integer labels and label names."""

    def __init__(self, mapping: Mapping[ColorKey, Tuple[int, str]]):
        self._color_to_entry: Dict[RGBColor, Tuple[int, str]] = {
            _parse_color(color): (int(index), str(label))
            for color, (index, label) in mapping.items()
        }
        self._index_to_color: Dict[int, RGBColor] = {}
        self._label_to_color: Dict[str, RGBColor] = {}
        for color, (index, label) in sorted(
            self._color_to_entry.items(), key=lambda kv: kv[1][0]
        ):
            # first color registered for an index or label wins (stable for duplicates)
            self._index_to_color.setdefault(index, color)
            self._label_to_color.setdefault(label, color)

    def __len__(self) -> int:
        return len(self._color_to_entry)

    @classmethod
    def load(cls, path) -> "ColorMap":
        with open(path, "r") as f:
            raw = json.load(f)
        return cls({k: (v[0], v[1]) for k, v in raw.items()})

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump({str(c): list(e) for c, e in self._color_to_entry.items()}, f, indent=2)

    def color_for_label(self, label: str) -> RGBColor:
        return self._label_to_color[label]

    def index_for_label(self, label: str) -> int:
        return self._color_to_entry[self._label_to_color[label]][0]

    @property
    def n_classes(self) -> int:
        if not self._index_to_color:
            return 0
        return max(self._index_to_color) + 1

    @property
    def palette(self) -> np.ndarray:
        """(n_classes, 3) uint8 palette; unmapped indices are black."""
        pal = np.zeros((max(self.n_classes, 1), 3), dtype=np.uint8)
        for index, color in self._index_to_color.items():
            pal[index] = color
        return pal

    def to_rgb_array(self, labels: np.ndarray) -> np.ndarray:
        """Label image -> RGB uint8 image, labels clipped to the palette."""
        pal = self.palette
        clipped = np.clip(np.asarray(labels).astype(np.int64), 0, pal.shape[0] - 1)
        return pal[clipped]

    def to_labels(self, rgb: np.ndarray) -> np.ndarray:
        """RGB image -> int32 label image; unknown colors map to 0, and a
        gray (H, W) image is taken as labels."""
        rgb = np.asarray(rgb)
        if rgb.ndim == 2:
            return rgb.astype(np.int32)
        rgb = rgb[..., :3]
        packed = (rgb[..., 0].astype(np.int64) << 16 | rgb[..., 1].astype(np.int64) << 8
                  | rgb[..., 2].astype(np.int64))
        out = np.zeros(rgb.shape[:-1], dtype=np.int32)
        for (r, g, b), (index, _label) in self._color_to_entry.items():
            out[packed == (r << 16 | g << 8 | b)] = index
        return out

    def imread_labels(self, path) -> np.ndarray:
        from .image_io import imread_rgb

        return self.to_labels(imread_rgb(path))

    def filter_label(self, image: np.ndarray, label: str) -> np.ndarray:
        """0/1 uint8 mask of the pixels of ``label``: its color in an RGB
        image, its index in a (H, W) label image."""
        image = np.asarray(image)
        if image.ndim == 2:
            return (image == self.index_for_label(label)).astype(np.uint8)
        return exact_color_mask(image, self.color_for_label(label)) >> 7


def exact_color_mask(image: np.ndarray, color: RGBColor) -> np.ndarray:
    """0/255 uint8 mask of the pixels of an (H, W, 3+) image that equal
    ``color`` exactly."""
    image = np.asarray(image)[..., :3]
    if image.dtype == np.uint8:
        # one compare of packed 24-bit keys instead of three channel compares
        key = np.uint32(color[0] << 16 | color[1] << 8 | color[2])
        packed = (image[..., 0].astype(np.uint32) << 16 | image[..., 1].astype(np.uint32) << 8
                  | image[..., 2])
        return (packed == key).view(np.uint8) * np.uint8(255)
    return (image == np.asarray(color, image.dtype)).all(axis=-1).astype(np.uint8) * np.uint8(255)


DEFAULT_IMAGE_MAP = ColorMap(
    {
        (255, 255, 255): (0, "background"),
        (255, 0, 0): (1, "text"),
        (0, 255, 0): (2, "image"),
    }
)
