"""One-pass multichannel front end.

Port of `directdemod_tpu/models/multichannel.py`. The reference decodes
each `-f` channel with a separate pass over the capture (ref main.py:147);
here the channels share one read: `MultiDdcFm` is a `frontend.DdcFm` whose
constants carry a channel axis (per-channel modulated taps, rotation and
block-0 history), so `frontend.DdcFmStream` runs every block of it through
ONE launch of K1 (raw bytes) or K4 (complex samples) for all channels, the
block staged once on the card. Each channel computes what the
single-channel front end at its offset computes, output for output.

With `mesh=` (`parallel.mesh`) the channels are split over its `channel`
shards, each shard a bank of its own on its device: every block is copied
to each shard's device and runs there through one kernel launch for the
shard's channels. There is no other exchange between the shards.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..io.feeder import BlockFeeder
from .frontend import DdcFm, DdcFmStream


class MultiDdcFm(DdcFm):
    """The fused DDC (+FM) of `freqs` channels; `process` returns
    ((n_channels, M) outputs, out_rate)."""

    def __init__(self, fs: int, freqs, taps, bw_target: int, fm: bool = True,
                 mesh=None):
        self.fes = [DdcFm(fs, f, taps, bw_target, fm) for f in freqs]
        if not self.fes:
            raise ValueError("MultiDdcFm needs at least one channel")
        self.freqs = tuple(freqs)
        self._set(np.stack([fe.taps_mod for fe in self.fes]),
                  np.asarray([complex(fe.rot) for fe in self.fes]),
                  np.stack([fe.hist0 for fe in self.fes]),
                  self.fes[0].stride, fm)
        self.out_rate = self.fes[0].out_rate
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import require_one_process
            require_one_process(mesh, "MultiDdcFm's channel mesh")
            nch = mesh.shape["channel"]
            if len(self.fes) % nch:
                raise ValueError(
                    f"{len(self.fes)} channels not divisible by the mesh's "
                    f"channel axis ({nch})")
            per = len(self.fes) // nch
            self._shards = [MultiDdcFm(fs, self.freqs[i * per:(i + 1) * per], taps,
                                       bw_target, fm) for i in range(nch)]

    @property
    def channels(self) -> int:
        return len(self.fes)

    def init_state(self, dtype=torch.complex64, device=None) -> tuple:
        """(history, c_prev) before block 0: (C, K-1) and (C, 1), as the
        reference's bank gives them."""
        hist, c_prev = super().init_state(dtype, device)
        return hist, c_prev[:, None]

    def process(self, source, block_size: int = constants.PROC_CHUNKSIZE,
                device=None, dtype=torch.complex64) -> tuple[np.ndarray, int]:
        """As `DdcFm.process`; with a mesh each channel shard runs on its
        own device (the mesh's, not `device`), the blocks fed to the first
        shard's device and copied from there to the others."""
        if self.mesh is None:
            return super().process(source, block_size, device, dtype)
        streams = [DdcFmStream(sh, d, dtype)
                   for sh, d in zip(self._shards, self.mesh.channel_devices)]
        outs = [torch.cat([st.step(x.to(st.device), s).cpu() for st in streams])
                for s, _, x in BlockFeeder(source, block_size, streams[0].device,
                                           dtype)]
        return torch.cat(outs, dim=-1).numpy(), self.out_rate
