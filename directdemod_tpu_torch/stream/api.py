"""The chainable stream API.

Port of `directdemod_tpu/stream/api.py`, the user-facing form of the
reference's `commSignal` chain (ref comm.py:15-181, tutorial/3_chunking.py:24-40):

    audio, rate = (Stream(source)
                   .shift(30000)
                   .filter(filters.blackman_harris(151))
                   .bw_limit(60000)
                   .fm_demod()
                   .run())

The chain is a recipe: `run()` builds a `stream.pipeline.Pipeline` and
streams the source through it block by block; `run_fused()` runs a
shift -> FIR -> bw_limit [-> fm_demod] chain as the fused front end
(`models.frontend.DdcFm`, K4 on complex blocks and K1 on raw ones), and
`run_sharded(mesh)` runs that front end over the `time` shards of a mesh
(`parallel.sharded`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import PROC_CHUNKSIZE
from ..device import resolve
from ..ops.iir import IirFilter
from . import pipeline as pl


class Stream:
    """A chain of stream ops over `source`, run on `device` (the port's
    device rule, `device.resolve`) in `dtype` (complex64 or complex128)."""

    def __init__(self, source, dtype=torch.complex64, device=None):
        self.source = source
        self.dtype = dtype
        self.device = resolve(device)
        self._ops: list[pl.StreamOp] = []

    def shift(self, freq: float) -> "Stream":
        """Frequency offset (ref comm.offsetFreq)."""
        self._ops.append(pl.Shift(freq))
        return self

    def filter(self, taps_or_filter, zero_phase: bool = False) -> "Stream":
        """FIR taps (an array) or an IirFilter (ref comm.filter)."""
        if isinstance(taps_or_filter, IirFilter):
            self._ops.append(pl.ButterZeroPhase(taps_or_filter) if zero_phase
                             else pl.Butter(taps_or_filter))
        else:
            taps = np.asarray(taps_or_filter)
            self._ops.append(pl.FilterZeroPhase(taps) if zero_phase
                             else pl.Filter(taps))
        return self

    def bw_limit(self, target_rate: int, strict: bool = False) -> "Stream":
        """Decimate (phase carried) or exact-rate resample (ref comm.bwLim)."""
        self._ops.append(pl.Resample(target_rate) if strict
                         else pl.BwLim(target_rate))
        return self

    def fm_demod(self) -> "Stream":
        self._ops.append(pl.FmDemod())
        return self

    def apply(self, fn) -> "Stream":
        """Any stateless function of a block's tensor (ref comm.funcApply)."""
        self._ops.append(pl.Apply(fn))
        return self

    def build(self) -> pl.Pipeline:
        return pl.Pipeline(list(self._ops), self.source.sampFreq,
                           dtype=self.dtype, device=self.device)

    def run(self, block_size: int = PROC_CHUNKSIZE) -> tuple[np.ndarray, int]:
        """Stream the whole source; returns (signal, sample rate)."""
        return self.build().process(self.source, block_size=block_size)

    def run_fused(self, block_size: int = PROC_CHUNKSIZE
                  ) -> tuple[np.ndarray, int]:
        """The fused front end when the chain is shift -> FIR -> bw_limit
        [-> fm_demod]; any other chain runs as `run`."""
        fe = self._as_ddc()
        if fe is None:
            return self.run(block_size)
        return fe.process(self.source, block_size=block_size,
                          device=self.device, dtype=self.dtype)

    def run_sharded(self, mesh, block_size: int = PROC_CHUNKSIZE
                    ) -> tuple[np.ndarray, int]:
        """The fused front end in waves of blocks over `mesh`'s `time`
        shards (`parallel.sharded.ShardedDdcFm`, on the mesh's devices);
        only a shift -> FIR -> bw_limit [-> fm_demod] chain runs so."""
        fe = self._as_ddc()
        if fe is None:
            raise ValueError("run_sharded requires a shift->FIR->bw_limit"
                             "[->fm_demod] chain")
        from ..parallel.sharded import ShardedDdcFm
        return ShardedDdcFm(fe, mesh).process(self.source, block_size,
                                              dtype=self.dtype)

    def _as_ddc(self):
        from ..models.frontend import DdcFm
        ops = self._ops
        shapes = [type(o) for o in ops]
        if shapes[:3] == [pl.Shift, pl.Filter, pl.BwLim] and \
                shapes[3:] in ([], [pl.FmDemod]):
            return DdcFm(self.source.sampFreq, ops[0].freq, ops[1].taps,
                         ops[2].target, fm=len(ops) == 4)
        return None
