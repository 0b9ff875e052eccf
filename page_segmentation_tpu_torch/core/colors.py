"""RGB <-> label codec: the part of ``ColorMap`` the predict path needs.

The on-disk JSON form and the RGB -> label direction stay in the JAX
package until a later slice needs them here.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

RGBColor = Tuple[int, int, int]


class ColorMap:
    """Mapping between RGB colors, integer labels and label names."""

    def __init__(self, mapping: Mapping[RGBColor, Tuple[int, str]]):
        self._color_to_entry: Dict[RGBColor, Tuple[int, str]] = {
            tuple(int(c) for c in color): (int(index), str(label))
            for color, (index, label) in mapping.items()
        }
        self._index_to_color: Dict[int, RGBColor] = {}
        for color, (index, _label) in sorted(
            self._color_to_entry.items(), key=lambda kv: kv[1][0]
        ):
            # first color registered for an index wins (stable for duplicates)
            self._index_to_color.setdefault(index, color)

    def __len__(self) -> int:
        return len(self._color_to_entry)

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


DEFAULT_IMAGE_MAP = ColorMap(
    {
        (255, 255, 255): (0, "background"),
        (255, 0, 0): (1, "text"),
        (0, 255, 0): (2, "image"),
    }
)
