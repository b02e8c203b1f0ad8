"""Block feed from a source to the decoder's device.

Port of `directdemod_tpu/io/feeder.py` and `directdemod_tpu/stream/plan.py`.
The reference kept a background thread a few blocks ahead of its device;
here the feed is a plain loop. For a CUDA device, raw bytes go through two
pinned host buffers used in turn: the copy of one block to the card runs
asynchronously while the next block is read into the other buffer, and a
buffer is reused only after its previous copy has finished.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import PROC_CHUNKSIZE


def plan_blocks(length: int, block_size: int = PROC_CHUNKSIZE) -> list[tuple[int, int]]:
    """[start, end) spans: fixed-size blocks plus one remainder block (the
    reference chunker's split, which is part of the numeric contract)."""
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


class BlockFeeder:
    """Iterate (start, end, block) over a source's block plan, each block a
    tensor on `device`: raw interleaved uint8 bytes when the source has them
    (`read_raw_device` or `read_raw`), else complex64 samples."""

    def __init__(self, source, block_size: int = PROC_CHUNKSIZE, device="cpu"):
        self.source = source
        self.device = torch.device(device)
        self.plan = plan_blocks(source.length, block_size)

    def __iter__(self):
        src = self.source
        if callable(getattr(src, "read_raw_device", None)):
            for s, e in self.plan:
                yield s, e, src.read_raw_device(s, e).to(self.device)
        elif callable(getattr(src, "read_raw", None)):
            if self.device.type == "cuda":
                yield from self._pinned_raw()
            else:
                for s, e in self.plan:
                    yield s, e, torch.from_numpy(np.array(src.read_raw(s, e),
                                                          dtype=np.uint8))
        else:
            for s, e in self.plan:
                x = np.array(src.read(s, e), dtype=np.complex64)
                yield s, e, torch.from_numpy(x).to(self.device)

    def _pinned_raw(self):
        bufs: list = [None, None]
        copied: list = [None, None]
        for i, (s, e) in enumerate(self.plan):
            host = self.source.read_raw(s, e)
            slot = i % 2
            if copied[slot] is not None:
                copied[slot].synchronize()
            if bufs[slot] is None or bufs[slot].numel() < len(host):
                bufs[slot] = torch.empty(len(host), dtype=torch.uint8,
                                         pin_memory=True)
            pinned = bufs[slot][: len(host)]
            pinned.numpy()[:] = host
            block = pinned.to(self.device, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record()
            yield s, e, block
