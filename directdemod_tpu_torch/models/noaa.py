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

The stages' work on the device is in module functions (`crude_sync_rows`,
`usefulness`, `decode_image`, `window_starts`, `iq_windows`,
`mix_windows`, `demod_envelope`, `fast_rows`) that `models.noaa_bank`
runs for several channels of one capture.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from .. import constants as K
from ..io.feeder import BlockFeeder
from ..io.sources import device_bytes
from ..ops import am as am_ops
from ..ops import correlate as corr_ops
from ..ops import design, fir, fm as fm_ops, iir, peaks, resample as rs
from ..ops import unpack
from ..utils.profiling import Profiler
from .frontend import DdcFm, DdcFmStream
from .stages import TimedDecoder, span

log = logging.getLogger(__name__)

AM_BLOCK = 60000 * 4        # blockwise-Hilbert chunk (ref decode_noaa.py:647)
WINDOW_GROUP = 64           # accurate-sync windows per device batch


class NoaaDecoder(TimedDecoder):
    """Decode NOAA APT from an IQ source on `device`.

    The surface of the reference: `useful`, `get_audio()`, `get_image()`,
    `image_a`/`image_b`, `get_color()`, `channel_id`, `get_crude_sync()`,
    `get_accurate_sync()`, each computed once and cached. `device` and
    `stage_seconds` as `TimedDecoder` gives them.

    `profiler` (`utils.profiling.Profiler`) records what the JAX decoder's
    does: "fm_frontend" with e - s for each block (the capture's length
    where the bytes on the device make it one block, and on the mesh), and
    "sync_correlate" with 2 n around the crude-sync correlation of n audio
    samples. Where the JAX decoder fuses front end and sync search into one
    "frontend+sync" stage (its resident crude-sync path) the port runs them
    as two stages and records them under those two names.

    Spans and counters (`TimedDecoder`) below the stages: the crude sync's
    `noaa.crude_sync.group` (both rows grouped on the device, ending with
    one synchronise; `noaa.crude_sync.candidates` counted there, the
    samples above the thresholds, and `noaa.crude_sync.device_rows`, the
    rows grouped) and `noaa.crude_sync.copy` (the one copy of the syncs and
    that count to the host), on the path without a mesh;
    `noaa.crude_sync.syncs` kept (the mesh path too); the image's
    `noaa.image.lines` and `noaa.image.calibration`
    (`apt.assemble_image`)."""

    layer = "noaa"

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
        self.profiler = Profiler()   # per-stage Msamples/s (utils.profiling)

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
            with self._stage("fm_frontend"), \
                    self.profiler.stage("fm_frontend", self.src.length):
                audio, _ = ShardedDdcFm(fe, self.mesh).process(self.src, blk)
            return torch.from_numpy(audio).to(self.device), out_rate

        # bytes on the device, no block-wise resample: one block, one K1
        # launch (on a card the block plan's outputs, bit for bit)
        whole = (not strict and j2 == 1
                 and device_bytes(self.src, self.device) is not None)
        feed = BlockFeeder(self.src, K.PROC_CHUNKSIZE, self.device,
                           blocks=[(0, self.src.length)] if whole else None)
        stream = DdcFmStream(fe, self.device)
        outs = []
        off2 = 0
        with self._stage("fm_frontend"):
            for s, e, x in feed:
                with self.profiler.stage("fm_frontend", e - s):
                    y = stream.step(x, s)
                if strict:
                    y = rs.fft_resample(y, int(target_rate * y.shape[0]
                                               / decim_rate))
                elif j2 > 1:
                    n_pre = int(y.shape[0])
                    y = rs.decimate(y, off2, j2, rs.decim_count(n_pre, off2, j2))
                    off2 = (j2 - (n_pre - off2) % j2) % j2
                outs.append(y)
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), out_rate

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
        thresholds and the peak grouping on the device (with a mesh: the
        grouping on the host, over the gathered correlation)."""
        if self._sync_a is None:
            audio, rate = self._fm_audio(K.NOAA_CRUDESYNCSAMPRATE, strict=False)
            self._audio = (audio, rate)
            self._sync_rate = rate
            log.info("NOAA crude sync: correlating %d samples at %d Hz",
                     audio.shape[0], rate)
            with self._stage("crude_sync"), \
                    self.profiler.stage("sync_correlate", 2 * int(audio.shape[0])):
                if self.mesh is None:
                    self._sync_a, self._sync_b = crude_sync_rows(self, audio, rate)
                else:
                    from ..parallel.correlate import sharded_find_sync_peaks
                    env = am_ops.envelope_blocked(audio.float(), AM_BLOCK).cpu().numpy()
                    self._sync_a, self._sync_b = (
                        sharded_find_sync_peaks(
                            self.mesh, env,
                            corr_ops.apt_needle(bits, rate, K.NOAA_T, True), rate,
                            K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
                        for bits in (K.NOAA_SYNCA, K.NOAA_SYNCB))
            self._count("crude_sync.syncs", len(self._sync_a) + len(self._sync_b))
            self._useful = usefulness(self._sync_a, self._sync_b, rate)
        return [self._sync_a, self._sync_b]

    @property
    def useful(self) -> int:
        if self._sync_a is None:
            self.get_crude_sync()
        return self._useful

    # ------------------------------------------------------------- image
    def get_image(self) -> np.ndarray:
        """Calibrated APT image (ref decode_noaa.py:255-465)."""
        if self._image is None:
            self.get_crude_sync()
            audio, rate = self._audio
            with self._stage("image"):
                img, ida, idb = decode_image(audio, rate, self._sync_a,
                                             self._sync_b, self._sync_rate,
                                             self.mesh)
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
                starts = window_starts(syncs, self._sync_rate, fs, width,
                                       self.src.length)
                needle = corr_ops.apt_needle(bits, fs, K.NOAA_T,
                                             positive=use_norm_correlate)
                nj = torch.as_tensor(needle, dtype=torch.float32,
                                     device=self.device)
                reduce = (_fast_reduce if fast else _host_walk if self.mesh is None
                          else self._sharded_walk)
                found = []
                for g0 in range(0, len(starts), group):
                    gs = starts[g0:g0 + group]
                    found += reduce(iq_windows(self.src, self.device, gs, 2 * width),
                                    nj, self.offset, fs, use_norm_correlate, gs)
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


def crude_sync_rows(dec: TimedDecoder, audio: torch.Tensor, rate: int
                    ) -> list:
    """The crude sync of the FM audio `audio`, (n,) for one channel or
    (C, n) for a bank, at `rate`: envelope -> fused A/B normalized
    correlation -> adaptive thresholds -> min-distance grouping of every
    row (A and B of each channel), all on the device; one copy of the syncs
    and the candidates' count to the host. Returns the rows' sync indices
    on the host, [A, B] or [A0, B0, A1, B1, ...]. Spans and counters go to
    `dec` (`TimedDecoder`) under its layer: `crude_sync.group`,
    `crude_sync.copy`, `crude_sync.candidates`, `crude_sync.device_rows`."""
    needles = _apt_needles(rate, audio.device)
    env = am_ops.envelope_blocked(audio.float(), AM_BLOCK)
    n = int(audio.shape[-1])
    cors = corr_ops.norm_correlate_multi_blocked(env, needles).reshape(-1, n)
    thr, _ = peaks.adaptive_threshold(cors, rate, K.NOAA_PEAKHEIGHTWIGGLE)
    cuda = cors.device.type == "cuda"
    if cuda:
        # wait for the correlation, so that the group span holds the
        # grouping alone
        torch.cuda.current_stream(cors.device).synchronize()
    with dec._span("crude_sync.group"):
        slots = peaks.group_peaks_dense(cors, thr, K.NOAA_MINPEAKDIST * rate)
        count = (cors > thr[:, None]).sum()
        if cuda:
            torch.cuda.current_stream(cors.device).synchronize()
    with dec._span("crude_sync.copy"):
        host = torch.cat([slots.reshape(-1), count.reshape(1)]).cpu().numpy()
    dec._count("crude_sync.candidates", int(host[-1]))
    dec._count("crude_sync.device_rows", int(cors.shape[0]))
    half = needles.shape[-1] // 2
    return [row[row < n] - half for row in host[:-1].reshape(cors.shape[0], -1)]


def usefulness(sync_a, sync_b, sync_rate: int) -> int:
    """10 consecutive syncs spaced 0.5 s within 5 samples
    (ref decode_noaa.py:793-804)."""
    for syncs in (sync_a, sync_b):
        d = np.abs(np.diff(syncs) - sync_rate * 0.5)
        w = K.NOAA_DETECTCONSSYNCSNUM
        if len(d) >= w:
            wins = np.lib.stride_tricks.sliding_window_view(d, w)
            if np.min(np.max(wins, axis=-1)) < K.NOAA_DETECTMAXCHANGE:
                return 1
    return 0


def decode_image(audio: torch.Tensor, rate: int, sync_a, sync_b,
                 sync_rate: int, mesh=None):
    """The calibrated APT image of one channel's FM audio `audio` (1-D, on
    its device, at `rate`) with its lines cut at the crude syncs `sync_a`,
    `sync_b` (at `sync_rate`; ref decode_noaa.py:255-465). With `mesh` the
    band-passed envelope comes from the exact sharded filtfilt and the
    block-parallel envelope. Returns (image, channel_id_a, channel_id_b)."""
    from . import apt
    bp = iir.IirFilter.design_butter(rate, 400, 4400, order=6, kind="bandpass")
    n_env = int(audio.shape[0])
    csync_a = np.asarray(sync_a, dtype=np.float64) / sync_rate * rate
    csync_b = np.asarray(sync_b, dtype=np.float64) / sync_rate * rate
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
    if mesh is not None:
        from ..parallel.am import sharded_envelope_blocked
        from ..parallel.iir import sharded_zero_phase
        filtered = sharded_zero_phase(mesh, bp, audio.float().cpu().numpy())
        env = torch.from_numpy(sharded_envelope_blocked(
            mesh, filtered, AM_BLOCK)).to(audio.device)
    return apt.assemble_image(audio, rate, csync_a, csync_b, ucsync, bp,
                              AM_BLOCK, env=env)


def window_starts(syncs, sync_rate: int, fs: float, width: int,
                  length: int) -> list:
    """First samples of the accurate sync's windows, 2 `width` samples
    about each crude sync (at `sync_rate`) mapped to the full rate `fs`,
    for the windows that lie inside the `length`-sample capture."""
    centers = np.asarray(syncs, dtype=np.float64) / sync_rate * fs
    return [int(c) - width for c in centers
            if int(c) - width >= 0 and int(c) + width <= length]


def iq_windows(src, device, starts: list, n_win: int) -> torch.Tensor:
    """(len(starts), n_win) complex64 IQ windows of `src` on `device`:
    gathered from the capture bytes where they already lie on the device,
    else read on the host and copied over."""
    raw = device_bytes(src, device)
    if raw is not None:
        idx = torch.as_tensor(np.asarray(starts, dtype=np.int64), device=device)
        return unpack.iq_u8_to_complex(raw.unfold(0, 2 * n_win, 2)[idx])
    rows = np.stack([src.read(s0, s0 + n_win) for s0 in starts])
    return torch.from_numpy(rows.astype(np.complex64)).to(device)


def _apt_needles(rate: int, device) -> torch.Tensor:
    """(2, L) A/B sync needle stack at `rate` (ref decode_noaa.py:690-694)."""
    na = corr_ops.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True)
    nb = corr_ops.apt_needle(K.NOAA_SYNCB, rate, K.NOAA_T, True)
    return torch.as_tensor(np.stack([na, nb]), dtype=torch.float32,
                           device=device)


def _window_envelope(batch: torch.Tensor, offset: float, fs: float
                     ) -> torch.Tensor:
    """Per-window chain at the full rate (ref decode_noaa.py:852): NCO with
    window-local phase -> zero-phase Blackman-Harris -> FM -> Hilbert
    envelope. (rows, n) complex -> (rows, n - 1) float32."""
    return demod_envelope(mix_windows(batch, offset, fs))


def mix_windows(batch: torch.Tensor, offset: float, fs: float) -> torch.Tensor:
    """The windows (rows, n) mixed down by `offset` Hz with window-local
    phase."""
    n = batch.shape[1]
    ph = torch.arange(n, dtype=torch.float32, device=batch.device) \
        * (-2.0 * np.pi * offset / fs)
    return batch * torch.polar(torch.ones_like(ph), ph)[None, :]


def demod_envelope(mixed: torch.Tensor) -> torch.Tensor:
    """Zero-phase Blackman-Harris -> FM -> Hilbert envelope of mixed
    windows: (rows, n) complex -> (rows, n - 1) float32."""
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
    return [f for f in fast_rows(env, cor, nj.shape[0], fs, starts) if f is not None]


def fast_rows(env: torch.Tensor, cor: torch.Tensor, ln: int, fs: float,
              starts) -> list:
    """`_fast_reduce`'s reduction of the windows' envelope and sync
    correlation rows (`ln` the needle's length), one entry a window: its
    (sync, quality, time sync or None), or None without a detection."""
    n = cor.shape[1]
    thr, _ = peaks.adaptive_threshold(cor, fs, K.NOAA_PEAKHEIGHTWIGGLE)
    mx, am = torch.max(cor, dim=-1)
    p = am - ln // 2
    ts_start = torch.clamp(p + ln, 0, n - ln)
    ts = env.unfold(1, ln, 1)[torch.arange(env.shape[0], device=env.device),
                              ts_start].mean(dim=-1)
    # the host waits here for the batch's filters and correlations
    with span("noaa.accurate_sync.copy"):
        has, p, mx, ts = (t.cpu().numpy() for t in (mx > thr, p, mx, ts))
    return [(int(p[row]) + s0, float(mx[row]),
             float(ts[row]) if p[row] + 2 * ln < n else None) if has[row] else None
            for row, s0 in enumerate(starts)]


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
