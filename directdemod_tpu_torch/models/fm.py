"""Generic wide/narrow FM decoder (broadcast audio, NOAA raw audio...).

Port of `directdemod_tpu/models/fm.py` (behavioral reference: `decode_fm`,
ref decode_fm.py:15-72): per block `offsetFreq -> blackmanHarris(151) ->
bwLim(bw) -> fm -> bwLim(audioFreq, strict)`, here the fused front end
(`frontend.DdcFmStream`: K4 on complex blocks, K1 on raw ones) and then a
per-block strict Fourier resample, or an integer decimation with its phase
carried (`strict=False`).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..io.feeder import BlockFeeder
from ..ops import design, resample as rs
from .frontend import DdcFm, DdcFmStream
from .stages import TimedDecoder


class FmDecoder(TimedDecoder):
    """FM audio of the channel at `offset` Hz on `device` (the port's
    device rule, `device.resolve`); `stage_seconds` holds `fm_frontend` and
    `resample`."""

    layer = "fm"

    def __init__(self, sigsrc, offset: float, bw: int | None = None,
                 audio_freq: int | None = None, strict: bool = True,
                 dtype=torch.complex64, device=None):
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = int(bw) if bw else 30000
        self.audio_freq = int(audio_freq) if audio_freq else 15000
        self.strict = strict
        self.dtype = dtype
        self._audio = None
        self._init_device(device)

    def get_audio(self) -> tuple[np.ndarray, int]:
        """Returns (audio, rate), the audio on the host."""
        if self._audio is not None:
            return self._audio
        fe = DdcFm(self.src.sampFreq, self.offset,
                   design.blackmanharris(151), self.bw)
        decim_rate = fe.out_rate
        j2 = 1 if self.strict else max(1, int(decim_rate // self.audio_freq))
        out_rate = self.audio_freq if self.strict else int(decim_rate / j2)
        stream = DdcFmStream(fe, self.device, self.dtype)
        outs = []
        off2 = 0
        for s, _, x in BlockFeeder(self.src, constants.PROC_CHUNKSIZE,
                                   self.device, self.dtype):
            with self._stage("fm_frontend"):
                y = stream.step(x, s)
            with self._stage("resample"):
                if self.strict:
                    y = rs.fft_resample(
                        y, int(self.audio_freq * y.shape[0] / decim_rate))
                elif j2 > 1:
                    n_pre = int(y.shape[0])
                    y = rs.decimate(y, off2, j2, rs.decim_count(n_pre, off2, j2))
                    off2 = (j2 - (n_pre - off2) % j2) % j2
            outs.append(y)
        self._audio = (torch.cat(outs).cpu().numpy(), out_rate)
        return self._audio
