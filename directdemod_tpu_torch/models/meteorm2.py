"""Meteor-M2 QPSK frame-sync detector.

Port of `directdemod_tpu/models/meteorm2.py` (ref decode_meteorm2.py:110-332):
120-symbol sync word with phase-ambiguity variants (odd/even-flipped), QPSK
Costas (bw 0.008727), AGC cap 200, interleaved-I/Q max-sync buffering, 0.11 s
frame spacing. The reference's needle-selection quirk (both >30 conditions
referencing buff4corr, so variant 2 wins -- ref decode_meteorm2.py:307-312)
is reproduced in ops/pll's scan.
"""
from __future__ import annotations

import numpy as np

from .. import constants as K
from ..constants import PROC_CHUNKSIZE
from ..ops.pll import PskParams
from .psk_sync import PskSyncDetector, _SyncConfig

# the 120-entry raw sync sequence quantized at >=7 (ref decode_meteorm2.py:167-170)
_RAW = [0, 13, 13, 12, 13, 13, 13, 0, 0, 0, 13, 13, 0, 13, 13, 0, 13, 0, 0, 0,
        13, 13, 13, 0, 0, 13, 0, 13, 0, 13, 0, 13, 13, 0, 0, 0, 13, 13, 0, 0,
        0, 0, 13, 0, 13, 13, 0, 0, 0, 0, 0, 13, 1, 13, 0, 13, 13, 13, 13, 12,
        0, 13, 0, 13, 0, 0, 13, 0, 13, 0, 13, 13, 0, 13, 13, 13, 0, 0, 0, 0,
        13, 0, 13, 0, 13, 13, 13, 13, 13, 0, 13, 13, 13, 0, 0, 0, 0, 13, 13,
        13, 0, 13, 0, 0, 0, 13, 0, 13, 13, 0, 13, 0, 13, 13, 0, 0, 0, 13, 13,
        13]
_SYNC = (np.asarray(_RAW) >= 7).astype(np.int64)


def _variants():
    s = _SYNC
    alt1 = np.where(np.arange(len(s)) % 2 == 0, s, 1 - s)   # flip odd idx
    alt2 = np.where(np.arange(len(s)) % 2 == 1, s, 1 - s)   # flip even idx
    return s, alt1, alt2


def _needle(bits: np.ndarray) -> np.ndarray:
    pm = np.where(bits == 1, 127.0, -128.0)
    return np.repeat(pm, int(2048000 / K.METEOR_SYMRATE))


class MeteorM2Decoder(PskSyncDetector):
    def __init__(self, sigsrc, offset, bw=None, block_size=None,
                 n_segments=None, device=None, mesh=None):
        bw = int(bw) if bw else K.METEOR_DEFAULT_BW
        params = PskParams(
            fs=sigsrc.sampFreq, sym_rate=K.METEOR_SYMRATE, qpsk=True,
            agc_mean0=3.0, agc_gain_cap=200.0,
            costas_bw=0.008727, minsync_thresh=30.0)
        s, a1, a2 = _variants()
        cfg = _SyncConfig(
            sym_sync=s, sym_sync_alt=a1,
            needles=[_needle(s), _needle(a1), _needle(a2)],
            entries_per_sample=2,
            cap_entries=2 * len(_needle(s)),
            arm_pre_syms=int(0.1 * K.METEOR_SYMRATE) - 2 * len(s),
            arm_end_syms=int(1.0 * K.METEOR_SYMRATE),
            frame_spacing=K.METEOR_FRAME_SPACING_S * sigsrc.sampFreq,
            spacing_tol=0.05 * sigsrc.sampFreq)
        super().__init__(sigsrc, offset, bw, params, cfg,
                         block_size=block_size or PROC_CHUNKSIZE,
                         n_segments=n_segments, device=device, mesh=mesh)

    @property
    def getSyncs(self):
        return self.get_syncs()
