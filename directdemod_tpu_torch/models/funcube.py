"""Funcube BPSK frame-sync detector.

Port of `directdemod_tpu/models/funcube.py` (ref decode_funcube.py:110-306):
33-bit frame sync, 1200 bps data on 12 ksym/s BPSK, Costas bandwidth
0.05235833*6, AGC cap 20, 4.98 s frame spacing, optional Doppler correction
with a slew-limited per-sample frequency ramp (ref decode_funcube.py:204-228).
"""
from __future__ import annotations

import numpy as np

from .. import constants as K
from ..constants import PROC_CHUNKSIZE
from ..io.sources import device_bytes
from ..ops.pll import PskParams
from .doppler import DopplerTracker
from .psk_sync import PskSyncDetector, _SyncConfig

_SYNC = np.asarray([int(c) for c in K.FUNCUBE_SYNC_BITS])


def _needle_2mhz() -> np.ndarray:
    """+-128-scaled sync at the 1200 bps bit duration (ref decode_funcube.py:175-177)."""
    pm = np.where(_SYNC == 1, 127.0, -128.0)
    return np.repeat(pm, int(2048000 / 1200))


class FuncubeDecoder(PskSyncDetector):
    def __init__(self, sigsrc, offset, bw=None, center_frequency=None,
                 signal_freq=None, corrfreq=False, block_size=None,
                 n_segments=None, device=None, mesh=None):
        bw = int(bw) if bw else K.FUNCUBE_DEFAULT_BW
        params = PskParams(
            fs=sigsrc.sampFreq, sym_rate=K.FUNCUBE_SYMRATE, qpsk=False,
            agc_mean0=180.0, agc_gain_cap=20.0,
            costas_bw=0.05235833333 * 6,
            minsync_thresh=120.0)
        sync12 = np.repeat(_SYNC, 10)
        needle = _needle_2mhz()
        cfg = _SyncConfig(
            sym_sync=sync12, sym_sync_alt=sync12,
            needles=[needle], entries_per_sample=1,
            cap_entries=2 * len(needle),
            arm_pre_syms=int(4.9 * K.FUNCUBE_SYMRATE) - 2 * len(sync12),
            arm_end_syms=int(5.2 * K.FUNCUBE_SYMRATE),
            frame_spacing=K.FUNCUBE_FRAME_SPACING_S * sigsrc.sampFreq,
            spacing_tol=0.2 * sigsrc.sampFreq)

        freq_fn = None
        if corrfreq:
            self._init_device(device)
            # the waterfall reads a device source's (windowed) bytes where
            # they lie, a file source's whole memmap
            held = device_bytes(sigsrc)
            tracker = DopplerTracker(sigsrc.memmap if held is None else held,
                                     sigsrc.sampFreq,
                                     int(center_frequency), int(signal_freq),
                                     device=self.device)
            base_offset = float(offset)
            state = {"current": None}

            def freq_fn(ci, n_chunks, n):
                """Slew-limited ramp toward the per-chunk Doppler target
                (ref decode_funcube.py:211-228)."""
                target = base_offset + tracker.correct(ci, n_chunks)
                if state["current"] is None:
                    state["current"] = target
                slew = 2000.0 / PROC_CHUNKSIZE
                cur = state["current"]
                if target > cur:
                    f = cur + slew * np.arange(n, dtype=np.float64)
                    f = np.minimum(f, target)
                else:
                    f = cur - slew * np.arange(n, dtype=np.float64)
                    f = np.maximum(f, target)
                state["current"] = float(f[-1])
                return f

        super().__init__(sigsrc, offset, bw, params, cfg, freq_fn=freq_fn,
                         block_size=block_size or PROC_CHUNKSIZE,
                         n_segments=n_segments, device=device, mesh=mesh)

    @property
    def getSyncs(self):
        """Reference-compatible property alias."""
        return self.get_syncs()
