"""NOAA APT decoder.

Port of `directdemod_tpu/models/noaa.py`: FM front end -> blocked AM
envelope -> normalized A/B sync correlation -> usefulness test -> calibrated
image -> accurate per-sync refinement, plus false colour and channel IDs.

Sampling-rate contract: the "40960 Hz" crude-sync request decays to the
integer-stride rate int(2048000 / 34) = 60235 Hz, as in the reference, and
crude sync indices live at that rate. Indices are int64 throughout; the
reference's packing of indices into float32 pairs and its fixed candidate
slots were workarounds for its device link and are not ported.

With `mesh=` (`parallel.mesh`) the decode runs its stages over the mesh's
`time` shards as the JAX decoder does: the front end in waves of blocks
(`parallel.sharded`, K1 or K4 on each shard), the crude sync search with
needle halos (`parallel.correlate`), the image stage's exact filtfilt and
blocked envelope (`parallel.iir`, `parallel.am`), and the accurate sync's
window batches split over the shards (the generic per-window walk).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import constants as K
from ..io.feeder import BlockFeeder
from ..ops import am as am_ops
from ..ops import correlate as corr_ops
from ..ops import design, fir, fm as fm_ops, iir, peaks, resample as rs
from ..ops import unpack
from .frontend import DdcFm, DdcFmStream
from .stages import TimedDecoder

log = logging.getLogger(__name__)

AM_BLOCK = 60000 * 4        # blockwise-Hilbert chunk (ref decode_noaa.py:647)
WINDOW_GROUP = 64           # accurate-sync windows per device batch


class NoaaDecoder(TimedDecoder):
    """Decode NOAA APT from an IQ source on `device`.

    The surface of the reference: `useful`, `get_audio()`, `get_image()`,
    `image_a`/`image_b`, `get_color()`, `channel_id`, `get_crude_sync()`,
    `get_accurate_sync()`, each computed once and cached. `device` and
    `stage_seconds` as `TimedDecoder` gives them."""

    def __init__(self, sigsrc, offset: float, bw: int | None = None,
                 device=None, mesh=None):
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = int(bw) if bw else K.NOAA_FMBW
        self._init_device(device)
        self.mesh = mesh             # optional: stages over its time shards
        self._audio = None           # (tensor, rate) at the crude-sync rate
        self._audio_strict = None    # (ndarray, rate) at NOAA_AUDSAMPRATE
        self._sync_a = None
        self._sync_b = None
        self._sync_rate = None
        self._useful = 0
        self._image = None
        self._color = None
        self._ch_id = (None, None)
        self._accurate = None

    # ------------------------------------------------------------- front end
    def _frontend(self) -> DdcFm:
        return DdcFm(self.src.sampFreq, self.offset,
                     design.blackmanharris(151), self.bw)

    def _fm_audio(self, target_rate: int, strict: bool):
        """The chunked FM chain (ref decode_noaa.py:600-629) through the
        fused front end, as a tensor on the decoder's device. strict=False
        keeps the integer-stride rate (decimated further by an integer when
        that rate is at least twice the target); strict=True
        Fourier-resamples each block (ref comm.py:110-116)."""
        fe = self._frontend()
        decim_rate = fe.out_rate
        j2 = int(decim_rate // target_rate) if not strict else 1
        out_rate = int(decim_rate / j2) if not strict else target_rate

        if self.mesh is not None and not strict and j2 == 1:
            # without a strict resample the chain does not depend on the
            # block size (every carry is exact): blocks that keep every
            # shard busy
            from ..parallel.sharded import ShardedDdcFm
            ndev = self.mesh.shape["time"]
            blk = int(min(K.PROC_CHUNKSIZE,
                          max(1 << 20, self.src.length // (2 * ndev))))
            with self._stage("fm_frontend"):
                audio, _ = ShardedDdcFm(fe, self.mesh).process(self.src, blk)
            return torch.from_numpy(audio).to(self.device), out_rate

        if (self.mesh is None and not strict and j2 == 1
                and callable(getattr(self.src, "read_raw_device", None))
                and self.src.device == self.device):
            n = self.src.length
            with self._stage("fm_frontend"):
                audio = fe.resident_frontend(self.src.read_raw_device(0, n), n)
            return audio, out_rate

        stream = DdcFmStream(fe, self.device)
        outs = []
        off2 = 0
        with self._stage("fm_frontend"):
            for s, e, x in BlockFeeder(self.src, K.PROC_CHUNKSIZE, self.device):
                y = stream.step(x, s)
                if strict:
                    y = rs.fft_resample(y, int(target_rate * y.shape[0]
                                               / decim_rate))
                elif j2 > 1:
                    n_pre = int(y.shape[0])
                    y = rs.decimate(y, off2, j2, rs.decim_count(n_pre, off2, j2))
                    off2 = (j2 - (n_pre - off2) % j2) % j2
                outs.append(y)
        return torch.cat(outs), out_rate

    def get_audio(self):
        """Audio at NOAA_AUDSAMPRATE (ref decode_noaa.py:85-96), on the
        host."""
        if self._audio_strict is None:
            audio, rate = self._fm_audio(K.NOAA_AUDSAMPRATE, strict=True)
            self._audio_strict = (audio.cpu().numpy(), rate)
        return self._audio_strict

    # ------------------------------------------------------------- crude sync
    def get_crude_sync(self):
        """Sync locations at the crude rate (ref decode_noaa.py:769-806):
        blocked envelope, fused A/B normalized correlation, adaptive
        thresholds on the device; peak grouping on the host."""
        if self._sync_a is None:
            audio, rate = self._fm_audio(K.NOAA_CRUDESYNCSAMPRATE, strict=False)
            self._audio = (audio, rate)
            self._sync_rate = rate
            log.info("NOAA crude sync: correlating %d samples at %d Hz",
                     audio.shape[0], rate)
            with self._stage("crude_sync"):
                if self.mesh is None:
                    self._sync_a, self._sync_b = _crude_sync(audio, rate)
                else:
                    from ..parallel.correlate import sharded_find_sync_peaks
                    env = am_ops.envelope_blocked(audio.float(), AM_BLOCK).cpu().numpy()
                    self._sync_a, self._sync_b = (
                        sharded_find_sync_peaks(
                            self.mesh, env,
                            corr_ops.apt_needle(bits, rate, K.NOAA_T, True), rate,
                            K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
                        for bits in (K.NOAA_SYNCA, K.NOAA_SYNCB))
            self._useful = self._usefulness()
        return [self._sync_a, self._sync_b]

    def _usefulness(self) -> int:
        """10 consecutive syncs spaced 0.5 s within 5 samples
        (ref decode_noaa.py:793-804)."""
        for syncs in (self._sync_a, self._sync_b):
            d = np.abs(np.diff(syncs) - self._sync_rate * 0.5)
            w = K.NOAA_DETECTCONSSYNCSNUM
            if len(d) >= w:
                wins = np.lib.stride_tricks.sliding_window_view(d, w)
                if np.min(np.max(wins, axis=-1)) < K.NOAA_DETECTMAXCHANGE:
                    return 1
        return 0

    @property
    def useful(self) -> int:
        if self._sync_a is None:
            self.get_crude_sync()
        return self._useful

    # ------------------------------------------------------------- image
    def get_image(self) -> np.ndarray:
        """Calibrated APT image (ref decode_noaa.py:255-465)."""
        if self._image is None:
            from . import apt
            self.get_crude_sync()
            audio, rate = self._audio
            with self._stage("image"):
                bp = iir.IirFilter.design_butter(rate, 400, 4400, order=6,
                                                 kind="bandpass")
                n_env = int(audio.shape[0])
                csync_a = np.asarray(self._sync_a, dtype=np.float64) \
                    / self._sync_rate * rate
                csync_b = np.asarray(self._sync_b, dtype=np.float64) \
                    / self._sync_rate * rate
                ucsync = csync_a.copy()
                csync_a = apt.fill_syncs(csync_a, n_env)
                csync_b = apt.fill_syncs(csync_b, n_env)

                # channel A first, pairwise (ref decode_noaa.py:294-303)
                if csync_b and csync_a and csync_b[0] < csync_a[0]:
                    csync_b.pop(0)
                if csync_b and csync_a and csync_b[-1] < csync_a[-1]:
                    csync_a.pop(-1)
                if len(csync_a) != len(csync_b):
                    log.error("sync A/B count mismatch; deriving B from A")
                    csync_b = list(np.asarray(csync_a) + int(0.25 * rate))

                env = None
                if self.mesh is not None:
                    # the exact sharded filtfilt and the block-parallel
                    # envelope
                    from ..parallel.am import sharded_envelope_blocked
                    from ..parallel.iir import sharded_zero_phase
                    filtered = sharded_zero_phase(
                        self.mesh, bp, audio.float().cpu().numpy())
                    env = torch.from_numpy(sharded_envelope_blocked(
                        self.mesh, filtered, AM_BLOCK)).to(self.device)
                img, ida, idb = apt.assemble_image(audio, rate, csync_a,
                                                   csync_b, ucsync, bp,
                                                   AM_BLOCK, env=env)
            self._image = img
            self._ch_id = (ida, idb)
        return self._image

    @property
    def channel_id(self):
        if self._image is None:
            self.get_image()
        return list(self._ch_id)

    @property
    def image_a(self) -> np.ndarray:
        return self.get_image()[:, :1040]

    @property
    def image_b(self) -> np.ndarray:
        return self.get_image()[:, 1040:]

    def get_color(self) -> np.ndarray:
        """False-colour composite from channels A and B
        (ref decode_noaa.py:536-598)."""
        if self._color is None:
            from .falsecolor import false_color
            self._color = false_color(self.image_a, self.image_b)
        return self._color

    # ------------------------------------------------------------- accurate sync
    def get_accurate_sync(self, use_norm_correlate: bool = True):
        """Sub-window sync refinement at the full IQ rate
        (ref decode_noaa.py:808-880), windows batched on the device.

        Returns [asyncA, diff(asyncA), qualityA, timeA,
                 asyncB, diff(asyncB), qualityB, timeB].
        """
        if self._accurate is not None and self._accurate[0] == use_norm_correlate:
            return self._accurate[1]
        self.get_crude_sync()
        fs = self.src.sampFreq
        sync_time = K.NOAA_T * len(K.NOAA_SYNCA)
        width = int(3 * sync_time * fs)
        # the min-distance grouping degenerates to one group per window
        # whenever the group distance exceeds the window: the per-window
        # walk is then an argmax (the reference's fast path); a mesh takes
        # the generic walk, as the JAX decoder does
        fast = self.mesh is None and K.NOAA_MINPEAKDIST * fs >= 2 * width
        group = WINDOW_GROUP * (1 if self.mesh is None else self.mesh.shape["time"])

        results = []
        with self._stage("accurate_sync"):
            for bits, syncs in ((K.NOAA_SYNCA, self._sync_a),
                                (K.NOAA_SYNCB, self._sync_b)):
                centers = np.asarray(syncs, dtype=np.float64) \
                    / self._sync_rate * fs
                starts = [int(c) - width for c in centers
                          if int(c) - width >= 0
                          and int(c) + width <= self.src.length]
                needle = corr_ops.apt_needle(bits, fs, K.NOAA_T,
                                             positive=use_norm_correlate)
                nj = torch.as_tensor(needle, dtype=torch.float32,
                                     device=self.device)
                reduce = (_fast_reduce if fast else _host_walk if self.mesh is None
                          else self._sharded_walk)
                found = []
                for g0 in range(0, len(starts), group):
                    gs = starts[g0:g0 + group]
                    found += reduce(self._windows(gs, 2 * width), nj,
                                    self.offset, fs, use_norm_correlate, gs)
                results.append([[f[i] for f in found] for i in range(3)])
        (da, qa, ta), (db, qb, tb) = results
        out = [da, list(np.diff(da)), qa, ta, db, list(np.diff(db)), qb, tb]
        self._accurate = (use_norm_correlate, out)
        return out

    def _sharded_walk(self, batch, nj, offset, fs, use_norm, starts) -> list:
        """`_host_walk` with the window batch split over the mesh's `time`
        shards (the windows are independent: nothing passes between the
        shards). The batch is padded to a whole number of rows a shard with
        copies of its first row (zero rows would put NaNs through the
        normalized correlation), dropped after. Each shard walks its own
        rows, so on a mesh that spans processes only the detections are
        gathered (rows (sync, quality, time sync or NaN)), not the rows'
        envelope and correlation (about 0.9 MB a window)."""
        from ..parallel.mesh import gather_host
        mesh = self.mesh
        devs = mesh.time_devices
        ndev = len(devs)
        nw = batch.shape[0]
        pad = (-nw) % ndev
        if pad:
            batch = torch.cat([batch, batch[:1].expand(pad, -1)])
        per = batch.shape[0] // ndev
        found = {}
        for i in mesh.local_time:
            env, cor = _windows_env_cor(batch[i * per:(i + 1) * per].to(devs[i]),
                                        nj.to(devs[i]), offset, fs, use_norm)
            rows = _walk(env.cpu().numpy(), cor.cpu().numpy(), nj.shape[0], fs,
                         starts[i * per:min((i + 1) * per, nw)])
            found[i] = np.array([(p, q, np.nan if t is None else t) for p, q, t in rows],
                                dtype=np.float64).reshape(-1, 3)
        found = gather_host(mesh, found)
        return [(int(p), float(q), None if np.isnan(t) else float(t))
                for i in range(ndev) for p, q, t in found[i]]

    def _windows(self, starts: list, n_win: int) -> torch.Tensor:
        """(len(starts), n_win) complex64 IQ windows on the device: gathered
        from the capture bytes where they already lie on the device, else
        read on the host and copied over."""
        if (callable(getattr(self.src, "read_raw_device", None))
                and self.src.device == self.device):
            raw = self.src.read_raw_device(0, self.src.length)
            idx = torch.as_tensor(np.asarray(starts, dtype=np.int64),
                                  device=self.device)
            return unpack.iq_u8_to_complex(raw.unfold(0, 2 * n_win, 2)[idx])
        rows = np.stack([self.src.read(s0, s0 + n_win) for s0 in starts])
        return torch.from_numpy(rows.astype(np.complex64)).to(self.device)


def _apt_needles(rate: int, device) -> torch.Tensor:
    """(2, L) A/B sync needle stack at `rate` (ref decode_noaa.py:690-694)."""
    na = corr_ops.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True)
    nb = corr_ops.apt_needle(K.NOAA_SYNCB, rate, K.NOAA_T, True)
    return torch.as_tensor(np.stack([na, nb]), dtype=torch.float32,
                           device=device)


def _crude_sync(audio: torch.Tensor, rate: int) -> tuple[np.ndarray, np.ndarray]:
    """Envelope -> fused A/B normalized correlation -> adaptive thresholds
    -> candidates on the device; min-distance grouping on the host."""
    needles = _apt_needles(rate, audio.device)
    env = am_ops.envelope_blocked(audio.float(), AM_BLOCK)
    cors = corr_ops.norm_correlate_multi_blocked(env, needles)
    thr, _ = peaks.adaptive_threshold(cors, rate, K.NOAA_PEAKHEIGHTWIGGLE)
    out = []
    for row in range(2):
        idx, vals = peaks.candidates_above(cors[row], thr[row])
        if len(idx) == 0:
            out.append(np.empty(0, dtype=np.int64))
            continue
        grouped = peaks.group_peaks(idx, vals, K.NOAA_MINPEAKDIST * rate)
        out.append(np.sort(grouped - needles.shape[-1] // 2))
    return out[0], out[1]


def _window_envelope(batch: torch.Tensor, offset: float, fs: float
                     ) -> torch.Tensor:
    """Per-window chain at the full rate (ref decode_noaa.py:852): NCO with
    window-local phase -> zero-phase Blackman-Harris -> FM -> Hilbert
    envelope. (rows, n) complex -> (rows, n - 1) float32."""
    n = batch.shape[1]
    ph = torch.arange(n, dtype=torch.float32, device=batch.device) \
        * (-2.0 * np.pi * offset / fs)
    mixed = batch * torch.polar(torch.ones_like(ph), ph)[None, :]
    f = fir.fir_zero_phase(mixed, design.blackmanharris(151))
    d, _ = fm_ops.quad_demod(f, None)
    return am_ops.envelope(d)


def _windows_env_cor(batch, nj, offset, fs, use_norm):
    """Envelope, Hamming zero-phase filter and sync correlation of a window
    batch (ref decode_noaa.py:844-877, batched). Returns (env, cor)."""
    env = _window_envelope(batch, offset, fs)
    filt = fir.fir_zero_phase(env, design.hamming(492))
    corr_fn = corr_ops.norm_correlate if use_norm else corr_ops.correlate_same
    return env, corr_fn(filt, nj)


def _fast_reduce(batch, nj, offset, fs, use_norm, starts) -> list:
    """The whole per-window reduction on the device when each window holds
    one peak group (NOAA_MINPEAKDIST * fs >= window length): the detection
    is argmax(cor) - ln//2 if the max clears the adaptive threshold, the
    quality is the max itself and the "time sync" the envelope mean over the
    needle length after the sync (ref noaa.py:673-693). Returns
    (sync, quality, time sync or None) per window with a detection."""
    env, cor = _windows_env_cor(batch, nj, offset, fs, use_norm)
    ln = nj.shape[0]
    n = cor.shape[1]
    thr, _ = peaks.adaptive_threshold(cor, fs, K.NOAA_PEAKHEIGHTWIGGLE)
    mx, am = torch.max(cor, dim=-1)
    p = am - ln // 2
    ts_start = torch.clamp(p + ln, 0, n - ln)
    ts = env.unfold(1, ln, 1)[torch.arange(env.shape[0], device=env.device),
                              ts_start].mean(dim=-1)
    has, p, mx, ts = (t.cpu().numpy() for t in (mx > thr, p, mx, ts))
    return [(int(p[row]) + s0, float(mx[row]),
             float(ts[row]) if p[row] + 2 * ln < n else None)
            for row, s0 in enumerate(starts) if has[row]]


def _host_walk(batch, nj, offset, fs, use_norm, starts) -> list:
    """The generic per-window walk on the host (ref noaa.py:485-542): the
    full adaptive-threshold + min-distance grouping of each correlation
    row; the first group is the window's sync. Returns what `_fast_reduce`
    returns."""
    env, cor = _windows_env_cor(batch, nj, offset, fs, use_norm)
    return _walk(env.cpu().numpy(), cor.cpu().numpy(), nj.shape[0], fs, starts)


def _walk(env_np, cor_np, ln, fs, starts) -> list:
    """The walk of `_host_walk` over host envelope and correlation rows."""
    found = []
    for row, s0 in enumerate(starts):
        pk = peaks.host_find_sync_peaks(cor_np[row], fs, ln,
                                        K.NOAA_PEAKHEIGHTWIGGLE,
                                        K.NOAA_MINPEAKDIST)
        if len(pk) == 0:
            continue
        p = int(pk[0])
        found.append((p + s0, float(cor_np[row][p + ln // 2]),
                      float(np.mean(env_np[row][p + ln:p + 2 * ln]))
                      if p + 2 * ln < env_np.shape[1] else None))
    return found
