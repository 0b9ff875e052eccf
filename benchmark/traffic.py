"""The one traffic generator: seeded synthetic pages and their masks, from
a traffic mix's parameters.

Pages are a frozen, vectorised copy of ``chip_smoke.py``
``synthesize_pages`` (300-DPI A4 historical pages: rows of glyph blocks of
one line height, shades 10-59 on paper 235, 85 % of the glyph slots inked,
and every ``figure_every``-th page a figure block of shade 120), and masks a
copy of its ``layout_regions`` / ``layout_labels`` (text lines as class 1,
the figure as class 2, background 0).  The binaries are 0 on ink and 255 on
paper.  The draws come from ``numpy.random.default_rng(seed)``; the pages
are painted by one gather on ``device``.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

PAPER, FIGURE = 235, 120


def _grid(h: int, w: int, line_height: int):
    rows = np.arange(h // 8, h - h // 8 - line_height, int(line_height * 1.6))
    cols = np.arange(w // 10, w - w // 10 - 25, 35)
    return rows, cols


def _figure_box(h: int, w: int):
    return int(h * 0.7), int(h * 0.85), int(w * 0.2), int(w * 0.8)


def synthesize_pages(n: int, shape: Sequence[int], seed: int, line_height: int = 50,
                     figure_every: int = 3, device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """(pages, binaries), each (n, H, W) uint8 on the host."""
    h, w = (int(s) for s in shape)
    rng = np.random.default_rng(seed)
    rows, cols = _grid(h, w, line_height)
    present = rng.random((n, len(rows), len(cols))) < 0.85
    shades = rng.integers(10, 60, size=present.shape).astype(np.uint8)
    grid = np.full((n, len(rows) + 1, len(cols) + 1), PAPER, np.uint8)
    grid[:, :-1, :-1] = np.where(present, shades, PAPER)
    # each pixel's glyph row and column, or the paper sentinel
    row_of = np.full(h, len(rows), np.int64)
    for i, r in enumerate(rows):
        row_of[r:r + line_height] = i
    col_of = np.full(w, len(cols), np.int64)
    for i, c in enumerate(cols):
        col_of[c:c + 25] = i
    g = torch.from_numpy(grid).to(device)
    pages = g[:, torch.from_numpy(row_of).to(device)][:, :, torch.from_numpy(col_of).to(device)]
    r0, r1, c0, c1 = _figure_box(h, w)
    pages[::figure_every, r0:r1, c0:c1] = FIGURE
    binaries = (pages == PAPER).to(torch.uint8) * 255
    return pages.cpu().numpy(), binaries.cpu().numpy()


def layout_labels(i: int, shape: Sequence[int], line_height: int = 50,
                  figure_every: int = 3) -> np.ndarray:
    """The class map of page ``i``: each text line across the text column as
    1, the figure block as 2, background 0."""
    h, w = (int(s) for s in shape)
    rows, cols = _grid(h, w, line_height)
    labels = np.zeros((h, w), np.uint8)
    for r in rows:
        labels[r:r + line_height, cols[0]:cols[-1] + 25] = 1
    if i % figure_every == 0:
        r0, r1, c0, c1 = _figure_box(h, w)
        labels[r0:r1, c0:c1] = 2
    return labels


# ------------------------------------------------------------------ PNG
