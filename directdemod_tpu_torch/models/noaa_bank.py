"""NOAA APT from several channels of one capture, read once.

The reference decodes each `-f` channel of a recording with a pass of its
own (ref main.py:147), and so does `NoaaDecoder`. A station that records
the whole 137 MHz APT band during overlapping passes (NOAA-15, -18 and -19
at 137.620, 137.9125 and 137.100 MHz in one 2.048 Msps capture centred at
137.5 MHz) then runs the front end, and reads the capture, once a channel.
`NoaaBankDecoder` decodes every channel from one read:

- the front end is one `MultiDdcFm` stream (one K1 launch over a capture
  whose bytes lie on the device, else one a block), its (C, M) audio left
  on the device;
- the crude sync runs over all channels at once: the blocked envelope of
  (C, M), the A/B correlation into 2C rows, one threshold a row, one
  grouping of the 2C rows and one copy of their syncs to the host; then
  each channel's usefulness test;
- each useful channel's image is `NoaaDecoder`'s (`noaa.decode_image`,
  the calibration walk included); a channel that is not useful makes none
  unless it is asked for;
- the accurate sync gathers the windows of every useful channel, A and B,
  into shared device batches of `noaa.WINDOW_GROUP` rows, each row mixed
  at its own channel's offset.

`channels[i]` is channel i with `NoaaDecoder`'s surface, so the CLI and
`geo.map_overlay_from_filename` take it as they take a `NoaaDecoder`. Each
channel's crude syncs, usefulness and image equal those of a `NoaaDecoder`
at its offset over the same bytes. Its accurate syncs are computed by the
same chain in other batches: on the CPU the positions are equal and the
qualities agree to float32 rounding; on the card the FFT and convolution
plans of other batches may also move a tied correlation maximum by one
sample, as two processes' one-channel decodes may differ.

Stages (`TimedDecoder`, layer `noaa_bank`): `fm_frontend`, `crude_sync`,
`image` (every channel whose image the call makes), `accurate_sync`.
Counters: `noaa_bank.channels` (channels decoded), the crude sync's
(`noaa.crude_sync_rows`: `crude_sync.device_rows` is 2C) and
`crude_sync.syncs`, `accurate_sync.windows` and `accurate_sync.batches`
(windows over batches: how far the batches are shared across channels).
No mesh: the CLI decodes channel by channel on one.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import constants as K
from ..ops import correlate as corr_ops
from ..ops import design, fir
from .multichannel import MultiDdcFm
from .noaa import (WINDOW_GROUP, crude_sync_rows, decode_image, demod_envelope,
                   fast_rows, iq_windows, mix_windows, usefulness, window_starts)
from .stages import TimedDecoder

log = logging.getLogger(__name__)


class NoaaBankDecoder(TimedDecoder):
    """Decode NOAA APT at each of `offsets` (Hz from the capture's centre)
    of the IQ source `sigsrc` on `device`, the channels sharing `bw` (the
    front end's rate target, `K.NOAA_FMBW` by default). `channels` holds
    the per-channel surface; `useful` and `get_crude_sync()` give every
    channel's at once."""

    layer = "noaa_bank"

    def __init__(self, sigsrc, offsets, bw: int | None = None, device=None):
        self.src = sigsrc
        self.offsets = tuple(float(o) for o in offsets)
        if not self.offsets:
            raise ValueError("NoaaBankDecoder needs at least one channel")
        self.bw = int(bw) if bw else K.NOAA_FMBW
        self._init_device(device)
        self._audio = None           # ((C, M) tensor, rate) at the crude rate
        self._syncs = None           # [(A, B)] a channel, at the crude rate
        self._useful = None
        self._images: dict = {}      # channel -> (image, id A, id B)
        self._accurate: dict = {}    # (channel, use_norm) -> 8 columns
        self.channels = [NoaaBankChannel(self, i) for i in range(len(self.offsets))]

    # ------------------------------------------------------------- front end
    def _fm_audio(self) -> tuple[torch.Tensor, int]:
        """Every channel's FM audio at the crude-sync rate, (C, M) on the
        device: `NoaaDecoder._fm_audio`'s plan for all channels at once."""
        bank = MultiDdcFm(self.src.sampFreq, self.offsets,
                          design.blackmanharris(151), self.bw)
        j2 = int(bank.out_rate // K.NOAA_CRUDESYNCSAMPRATE)
        with self._stage("fm_frontend"):
            audio = bank.stream(self.src, self.device)
            if j2 > 1:
                audio = audio[..., ::j2]
        self._count("channels", len(self.offsets))
        return audio, int(bank.out_rate / j2)

    # ------------------------------------------------------------- crude sync
    def get_crude_sync(self) -> list:
        """[[A syncs, B syncs]] a channel at the crude rate."""
        if self._syncs is None:
            audio, rate = self._fm_audio()
            self._audio = (audio, rate)
            log.info("NOAA bank crude sync: %d channels of %d samples at %d Hz",
                     audio.shape[0], audio.shape[1], rate)
            with self._stage("crude_sync"):
                rows = crude_sync_rows(self, audio, rate)
            self._syncs = [(rows[2 * i], rows[2 * i + 1])
                           for i in range(len(self.offsets))]
            self._count("crude_sync.syncs", sum(len(r) for r in rows))
            self._useful = [usefulness(a, b, rate) for a, b in self._syncs]
        return [[a, b] for a, b in self._syncs]

    @property
    def useful(self) -> list:
        """The usefulness test of every channel, 1 or 0."""
        self.get_crude_sync()
        return list(self._useful)

    def _pending(self, index: int, done) -> list:
        """The channels a product is made for with channel `index`'s: the
        useful ones and `index`, less the channels in `done`."""
        self.get_crude_sync()
        return [i for i in range(len(self.offsets))
                if (self._useful[i] or i == index) and i not in done]

    # ------------------------------------------------------------- image
    def _image(self, index: int) -> tuple:
        """(image, channel id A, channel id B) of channel `index`, made with
        those of every useful channel not made yet, in one `image` stage."""
        if index not in self._images:
            todo = self._pending(index, self._images)
            audio, rate = self._audio
            with self._stage("image"):
                for i in todo:
                    a, b = self._syncs[i]
                    self._images[i] = decode_image(audio[i], rate, a, b, rate)
        return self._images[index]

    # ------------------------------------------------------------- accurate sync
    def _accurate_sync(self, index: int, use_norm: bool) -> list:
        """Channel `index`'s accurate syncs (`NoaaDecoder.get_accurate_sync`),
        made with those of every useful channel not made yet: their windows,
        A and B, in shared batches."""
        key = (index, use_norm)
        if key in self._accurate:
            return self._accurate[key]
        todo = self._pending(index, {i for i, u in self._accurate if u == use_norm})
        rate = self._audio[1]
        fs = self.src.sampFreq
        # a window, 6 sync lengths, holds one peak group at any rate
        # (NOAA_MINPEAKDIST exceeds it): `NoaaDecoder`'s fast reduction
        width = int(3 * K.NOAA_T * len(K.NOAA_SYNCA) * fs)
        needles = [torch.as_tensor(corr_ops.apt_needle(bits, fs, K.NOAA_T, use_norm),
                                   dtype=torch.float32, device=self.device)
                   for bits in (K.NOAA_SYNCA, K.NOAA_SYNCB)]
        ln = needles[0].shape[0]
        corr_fn = corr_ops.norm_correlate if use_norm else corr_ops.correlate_same
        # (channel, needle, first sample) a window, A windows first
        jobs = [(i, k, s0) for k in (0, 1) for i in todo
                for s0 in window_starts(self._syncs[i][k], rate, fs, width,
                                        self.src.length)]
        found = {(i, k): [] for i in todo for k in (0, 1)}
        with self._stage("accurate_sync"):
            for g0 in range(0, len(jobs), WINDOW_GROUP):
                group = jobs[g0:g0 + WINDOW_GROUP]
                starts = [s0 for _, _, s0 in group]
                batch = iq_windows(self.src, self.device, starts, 2 * width)
                mixed = torch.empty_like(batch)
                for i, rows in _rows_by(group, 0, self.device):
                    mixed[rows] = mix_windows(batch[rows], self.offsets[i], fs)
                env = demod_envelope(mixed)
                filt = fir.fir_zero_phase(env, design.hamming(492))
                cor = torch.empty_like(filt)
                for k, rows in _rows_by(group, 1, self.device):
                    cor[rows] = corr_fn(filt[rows], needles[k])
                for (i, k, _), f in zip(group, fast_rows(env, cor, ln, fs, starts)):
                    if f is not None:
                        found[(i, k)].append(f)
                self._count("accurate_sync.windows", len(group))
                self._count("accurate_sync.batches", 1)
        for i in todo:
            (da, qa, ta), (db, qb, tb) = ([[f[j] for f in found[(i, k)]] for j in range(3)]
                                          for k in (0, 1))
            self._accurate[(i, use_norm)] = [da, list(np.diff(da)), qa, ta,
                                             db, list(np.diff(db)), qb, tb]
        return self._accurate[key]


def _rows_by(group: list, field: int, device) -> list:
    """[(value, rows of `group` whose job has it at `field`)] in value
    order, the rows as an index tensor on `device`."""
    out: dict = {}
    for row, job in enumerate(group):
        out.setdefault(job[field], []).append(row)
    return [(v, torch.as_tensor(rows, dtype=torch.int64, device=device))
            for v, rows in sorted(out.items())]


class NoaaBankChannel:
    """Channel `index` of a `NoaaBankDecoder` with `NoaaDecoder`'s
    surface: `useful`, `get_crude_sync()`, `get_image()`, `image_a` /
    `image_b`, `channel_id`, `get_color()`, `get_accurate_sync()`. The bank
    makes each product for every channel that needs it, once."""

    def __init__(self, bank: NoaaBankDecoder, index: int):
        self.bank = bank
        self.index = index
        self.offset = bank.offsets[index]
        self._color = None

    @property
    def useful(self) -> int:
        return self.bank.useful[self.index]

    def get_crude_sync(self) -> list:
        return self.bank.get_crude_sync()[self.index]

    def get_image(self) -> np.ndarray:
        return self.bank._image(self.index)[0]

    @property
    def channel_id(self) -> list:
        return list(self.bank._image(self.index)[1:])

    @property
    def image_a(self) -> np.ndarray:
        return self.get_image()[:, :1040]

    @property
    def image_b(self) -> np.ndarray:
        return self.get_image()[:, 1040:]

    def get_color(self) -> np.ndarray:
        if self._color is None:
            from .falsecolor import false_color
            self._color = false_color(self.image_a, self.image_b)
        return self._color

    def get_accurate_sync(self, use_norm_correlate: bool = True) -> list:
        return self.bank._accurate_sync(self.index, use_norm_correlate)
