"""Connected components with stats, on the host.

Counterpart of ``page_segmentation_tpu/ops/cc.py`` with the output contract
of cv2.connectedComponentsWithStats:

* ``labels``: int32 label image, 0 = background, components numbered 1..n-1
  in row-major order of first touch;
* ``stats``: (n, 5) int32 rows ``[left, top, width, height, area]``, row 0
  the background over the whole image;
* ``centroids``: (n, 2) float64 ``(x, y)``.

Computed by the port's native union-find (``native/ps_native.cpp``
``ps_cc_with_stats``); the library builds or raises.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

CC_STAT_LEFT = 0
CC_STAT_TOP = 1
CC_STAT_WIDTH = 2
CC_STAT_HEIGHT = 3
CC_STAT_AREA = 4


class ConnectedComponents(NamedTuple):
    num_labels: int
    labels: np.ndarray
    stats: np.ndarray
    centroids: np.ndarray


def connected_components_with_stats(image: np.ndarray, connectivity: int = 4) -> ConnectedComponents:
    """Labels, stats and centroids of the nonzero pixels of ``image``."""
    from .. import native

    return ConnectedComponents(*native.cc_with_stats(image, connectivity))


def cc_window(cc_stats: np.ndarray, cc_index: int) -> Tuple[slice, slice]:
    """Row/column slices of one component's bounding box."""
    top, left = cc_stats[cc_index, CC_STAT_TOP], cc_stats[cc_index, CC_STAT_LEFT]
    h, w = cc_stats[cc_index, CC_STAT_HEIGHT], cc_stats[cc_index, CC_STAT_WIDTH]
    return slice(top, top + h), slice(left, left + w)
