"""Static-shape padding helpers used by the fused predict program."""
from __future__ import annotations


def round_up(value: int, factor: int) -> int:
    return -(-int(value) // factor) * factor
