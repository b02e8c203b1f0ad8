"""One-pass multichannel front end.

Port of `directdemod_tpu/models/multichannel.py` (less `mesh=`, which waits
for the port of `parallel/`). The reference decodes each `-f` channel with
a separate pass over the capture (ref main.py:147); here the channels share
one read: `MultiDdcFm` is a `frontend.DdcFm` whose constants carry a channel
axis (per-channel modulated taps, rotation and block-0 history), so
`frontend.DdcFmStream` runs every block of it through ONE launch of K1
(raw bytes) or K4 (complex samples) for all channels, the block staged once
on the card. Each channel computes what the single-channel front end at its
offset computes, output for output.
"""
from __future__ import annotations

import numpy as np

from .frontend import DdcFm


class MultiDdcFm(DdcFm):
    """The fused DDC (+FM) of `freqs` channels; `process` returns
    ((n_channels, M) outputs, out_rate)."""

    def __init__(self, fs: int, freqs, taps, bw_target: int, fm: bool = True):
        self.fes = [DdcFm(fs, f, taps, bw_target, fm) for f in freqs]
        if not self.fes:
            raise ValueError("MultiDdcFm needs at least one channel")
        self.freqs = tuple(freqs)
        self._set(np.stack([fe.taps_mod for fe in self.fes]),
                  np.asarray([complex(fe.rot) for fe in self.fes]),
                  np.stack([fe.hist0 for fe in self.fes]),
                  self.fes[0].stride, fm)
        self.out_rate = self.fes[0].out_rate

    @property
    def channels(self) -> int:
        return len(self.fes)
