"""Stream block planning.

Port of `directdemod_tpu/stream/plan.py` (behavioral reference: the
reference's chunker, ref chunker.py:21-45): fixed-size blocks of
PROC_CHUNKSIZE samples plus one remainder block. Block boundaries are part
of the numeric contract (the strict resample runs per block), so the plan
reproduces the reference's exact split.
"""
from __future__ import annotations

from ..constants import PROC_CHUNKSIZE


def plan_blocks(length: int, block_size: int = PROC_CHUNKSIZE) -> list[tuple[int, int]]:
    """[start, end) block spans over a signal of `length` samples."""
    blocks: list[tuple[int, int]] = []
    i = 0
    while i + block_size < length:
        blocks.append((i, i + block_size))
        i += block_size
    if not blocks:
        blocks.append((0, length))
    elif blocks[-1][1] != length:
        blocks.append((blocks[-1][1], length))
    return blocks
