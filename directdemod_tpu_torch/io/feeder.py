"""Block feed from a source to the decoder's device.

Port of `directdemod_tpu/io/feeder.py`; the block plan is `stream.plan`.
The reference kept a background thread a few blocks ahead of its device;
here the feed is a plain loop. For a CUDA device, host blocks (raw bytes or
complex samples) go through two pinned host buffers used in turn: the copy
of one block to the card runs asynchronously while the next block is read
into the other buffer, and a buffer is reused only after its previous copy
has finished.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import PROC_CHUNKSIZE
from ..device import resolve
from ..stream.plan import plan_blocks
from .sources import device_bytes

_NP_COMPLEX = {torch.complex64: np.complex64, torch.complex128: np.complex128}


class BlockFeeder:
    """Iterate (start, end, block) over a source's block plan, each block a
    tensor on `device` (the port's device rule, `device.resolve`): raw
    interleaved uint8 bytes when the source has them (`sources.device_bytes`
    or `read_raw`) and `raw` is true, else `dtype` (complex64 or complex128)
    samples from `read`. `blocks` replaces the plan of `block_size` blocks
    (e.g. the rest of a plan after a checkpoint, or one whole block)."""

    def __init__(self, source, block_size: int = PROC_CHUNKSIZE, device=None,
                 dtype=torch.complex64, raw: bool = True, blocks=None):
        self.source = source
        self.device = resolve(device)
        self.dtype = dtype
        self.raw = raw
        self.plan = (list(blocks) if blocks is not None
                     else plan_blocks(source.length, block_size))

    def __iter__(self):
        src = self.source
        held = device_bytes(src) if self.raw else None
        if held is not None:
            for s, e in self.plan:
                yield s, e, held[2 * s: 2 * e].to(self.device)
            return
        if self.raw and callable(getattr(src, "read_raw", None)):
            read, np_dtype = src.read_raw, np.uint8
        else:
            read, np_dtype = src.read, _NP_COMPLEX[self.dtype]
        if self.device.type == "cuda":
            yield from self._pinned(read, np_dtype)
            return
        for s, e in self.plan:
            yield s, e, torch.from_numpy(np.array(read(s, e), dtype=np_dtype))

    def _pinned(self, read, np_dtype):
        bufs: list = [None, None]
        copied: list = [None, None]
        dtype = torch.from_numpy(np.empty(0, np_dtype)).dtype
        for i, (s, e) in enumerate(self.plan):
            host = read(s, e)
            slot = i % 2
            if copied[slot] is not None:
                copied[slot].synchronize()
            if bufs[slot] is None or bufs[slot].numel() < len(host):
                bufs[slot] = torch.empty(len(host), dtype=dtype, pin_memory=True)
            pinned = bufs[slot][: len(host)]
            pinned.numpy()[:] = host
            block = pinned.to(self.device, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record()
            yield s, e, block
