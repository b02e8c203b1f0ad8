"""Funcube/Meteor frame-sync detection: chunk loop + two-pass max-sync search.

Port of `directdemod_tpu/models/psk_sync.py`. The reference interleaves,
per sample: (1) conditional buffering of PLL-rotated samples near expected
frame positions, (2) a correlation countdown, (3) Gardner/AGC/Costas symbol
processing with rolling-buffer "minsync" detection. Here, as in the JAX
package, in two passes:

  pass 1 (the decoder's device): unpack, chunk-local NCO, the continuous
  Butterworth low-pass of the complex stream, and the symbol-rate scan
  (`ops/pll`, K3 on a card), sequential or segment-parallel;
  pass 2 (host NumPy): the per-sample buffering and countdown replayed
  over the symbol -> sample map, the buffered values gathered from the
  filtered stream (kept on the device) and rotated by the piecewise-
  constant PLL phasor, one FFT correlation per detected frame.

The NCO phase restarts at every chunk and the low-pass carries state across
chunks: both reference quirks are kept. `get_syncs` keeps the JAX
package's two dispatch shapes: the whole capture at once (up to
`_CAPTURE_SEG_MAX` samples, default block size, no Doppler track) and the
block loop. The valid symbols come to the host in one copy per scan
(~14 B a symbol) and pass 2 reads them densely; the JAX package's sparse
event/span gathers, its event cap and its `_CoverageError` fallback existed
for its device link and are not ported (its sparse path is pinned equal to
the dense one). With `mesh=` (`parallel.mesh`) the segment scan runs over
the mesh's `time` shards (`pll.symbol_scan_segments(mesh=)`, one K3 launch
a shard), in the block loop, as the JAX decoder does.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import PROC_CHUNKSIZE
from ..io.feeder import BlockFeeder, plan_blocks
from ..ops import iir, nco, pll, unpack
from .stages import TimedDecoder

log = logging.getLogger(__name__)

# capture-level segmentation cap (the JAX package's): the filtered capture
# and the scan's working set both stay on the device
_CAPTURE_SEG_MAX = 128_000_000


class _DeviceStreamChain:
    """The retained span of the filtered stream: contiguous blocks kept on
    the decoder's device, each with its global first sample. `get` copies
    one window to the host; a window may straddle block boundaries (parts
    copy separately and join on the host)."""

    def __init__(self):
        self.segs: list = []       # [(device tensor, global lo)], contiguous

    def append(self, arr: torch.Tensor, lo: int) -> None:
        self.segs.append((arr, int(lo)))

    @property
    def lo(self) -> int:
        return self.segs[0][1] if self.segs else 0

    @property
    def hi(self) -> int:
        if not self.segs:
            return 0
        arr, lo = self.segs[-1]
        return lo + int(arr.shape[0])

    def get(self, a: int, b: int) -> np.ndarray:
        parts = []
        for arr, lo in self.segs:
            hi = lo + int(arr.shape[0])
            aa, bb = max(a, lo), min(b, hi)
            if bb > aa:
                parts.append(arr[aa - lo: bb - lo].cpu().numpy())
        if not parts:
            return np.empty(0, dtype=np.complex64)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def prune(self, keep_from: int) -> None:
        """Drop whole blocks that end at or before `keep_from`."""
        self.segs = [(arr, lo) for (arr, lo) in self.segs
                     if lo + int(arr.shape[0]) > keep_from]


class _RecordingStream:
    """Dry-run stand-in for a stream: records every requested window range
    and returns zeros. Pass 2's control flow (arming windows, countdowns,
    retriggers) depends only on the symbol streams, never on the window
    sample values, so a dry run discovers exactly which spans the real run
    will read."""

    def __init__(self, inner):
        self.inner = inner
        self.ranges: list = []

    @property
    def lo(self) -> int:
        return self.inner.lo

    @property
    def hi(self) -> int:
        return self.inner.hi

    def get(self, a: int, b: int) -> np.ndarray:
        a2, b2 = max(a, self.lo), min(b, self.hi)
        if b2 <= a2:
            return np.empty(0, dtype=np.complex64)
        self.ranges.append((a2, b2))
        return np.zeros(b2 - a2, dtype=np.complex64)


class _CachedStream:
    """Serves the ranges a _RecordingStream discovered from one batched
    gather; anything else falls through to the inner stream."""

    def __init__(self, inner, cache: dict):
        self.inner = inner
        self.cache = cache

    @property
    def lo(self) -> int:
        return self.inner.lo

    @property
    def hi(self) -> int:
        return self.inner.hi

    def get(self, a: int, b: int) -> np.ndarray:
        a2, b2 = max(a, self.lo), min(b, self.hi)
        hit = self.cache.get((a2, b2))
        return hit if hit is not None else self.inner.get(a, b)


def _prefetch_windows(chain: _DeviceStreamChain, ranges: list) -> dict:
    """One device gather and one copy for all of pass 2's correlation
    windows. Returns {(a, b): host window}."""
    if not ranges:
        return {}
    arrs = [a for a, _ in chain.segs]
    base = chain.lo
    full = arrs[0] if len(arrs) == 1 else torch.cat(arrs)
    n = int(full.shape[0])
    size = min(n, max(b - a for a, b in ranges))
    starts = [min(max(a - base, 0), n - size) for a, _ in ranges]
    idx = (torch.tensor(starts, dtype=torch.int64, device=full.device)[:, None]
           + torch.arange(size, device=full.device)[None, :])
    wins = full[idx].cpu().numpy()
    cache = {}
    for (a, b), s0, row in zip(ranges, starts, wins):
        off = (a - base) - int(s0)
        cache[(a, b)] = row[off: off + (b - a)]
    return cache


class _DenseSymbols:
    """Pass-2 symbol-stream view over the host copies of a scan's symbols:
    A-sample indices, phases and needle choices, in symbol order."""

    def __init__(self, a: np.ndarray, ph: np.ndarray, ch: np.ndarray):
        self.a, self.ph, self.ch = a, ph, ch

    def sym_sample(self, j: int):
        """Global sample of 0-based symbol j (ctr becomes j+1 there)."""
        return int(self.a[j]) if 0 <= j < len(self.a) else None

    def phase_at(self, n_arr: np.ndarray) -> np.ndarray:
        """PLL phase in effect at samples n_arr: the phase of the last
        symbol with a_idx < n (pllObj.output is updated when a symbol
        processes -- ref decode_funcube.py:61)."""
        pos = np.searchsorted(self.a, n_arr, side="left") - 1
        return np.where(pos >= 0, self.ph[np.clip(pos, 0, None)], 0.0)

    def chosen_before(self, n: int) -> int:
        pos = np.searchsorted(self.a, n, side="left") - 1
        return int(self.ch[pos]) if pos >= 0 else 0


class _GrowingSymbols(_DenseSymbols):
    """The block loop's _DenseSymbols: each block's symbols are appended
    into arrays that grow by doubling, where the JAX package concatenates
    every block's symbols again at each block (quadratic in the capture
    length). The lookups are the same."""

    def __init__(self):
        self._n = 0
        self._bufs = (np.empty(0, np.int64), np.empty(0, np.float32),
                      np.empty(0, np.int64))

    def append(self, a, ph, ch) -> None:
        n, k = self._n, len(a)
        if n + k > len(self._bufs[0]):
            cap = max(2 * len(self._bufs[0]), n + k)
            self._bufs = tuple(np.concatenate([b[:n], np.empty(cap - n, b.dtype)])
                               for b in self._bufs)
        for b, v in zip(self._bufs, (a, ph, ch)):
            b[n:n + k] = v
        self._n = n + k

    a = property(lambda self: self._bufs[0][:self._n])
    ph = property(lambda self: self._bufs[1][:self._n])
    ch = property(lambda self: self._bufs[2][:self._n])


def _lim(x: np.ndarray) -> np.ndarray:
    """ref decode_funcube.py:88-97: clamp to [-128,127], values in (0,1)->1,
    (-1,0)->-1, else int truncation."""
    out = np.trunc(x)
    out = np.where((x > 0) & (x < 1), 1, out)
    out = np.where((x > -1) & (x < 0), -1, out)
    return np.clip(out, -128, 127)


@dataclass
class _SyncConfig:
    sym_sync: np.ndarray        # 0/1 pattern at symbol rate (buffer compare)
    sym_sync_alt: np.ndarray    # QPSK alternate (== sym_sync for BPSK)
    needles: list               # +-128-valued full-rate needles (1 or 3)
    entries_per_sample: int     # 1 bpsk, 2 qpsk (interleaved I/Q)
    cap_entries: int            # maxResBuff cap (2 * len(needle))
    arm_pre_syms: int           # arming starts at ctr > lastMin + this
    arm_end_syms: int           # arming ends past ctr > lastMin + this
    frame_spacing: float        # expected sync spacing (samples)
    spacing_tol: float          # usefulness tolerance (samples)


def _host_symbols(syms: pll.Symbols):
    """(a_idx int64, phase float32, chosen int64, minsync bool) numpy
    arrays of a scan's symbols: one copy from the device."""
    a = syms.a_idx.cpu().numpy()
    ph = syms.phase_out.cpu().numpy()
    ch = syms.chosen.cpu().numpy().astype(np.int64)
    mf = syms.minsync.cpu().numpy()
    return a, ph, ch, mf


class PskSyncDetector(TimedDecoder):
    """Shared decoder; see FuncubeDecoder / MeteorM2Decoder for the configs.
    `device` and `stage_seconds` (`frontend`, `symbol_scan`, `pass2`) as
    `TimedDecoder` gives them."""

    def __init__(self, sigsrc, offset, bw: int, params: pll.PskParams,
                 cfg: _SyncConfig, freq_fn=None,
                 block_size: int = PROC_CHUNKSIZE,
                 n_segments: int | None = None, warmup_symbols: int = 2000,
                 device=None, mesh=None):
        """`n_segments` > 1 switches the PLL to the segment-parallel scan
        (`ops/pll.symbol_scan_segments`): the stream is split into segments
        with a `warmup_symbols` re-lock halo, each scanned independently
        (one K3 thread each on a card). This is the approximate scaling mode
        -- the same re-lock-transient tolerance the reference accepts at its
        own chunk boundaries. With `mesh` the segments are split over its
        `time` shards; `n_segments` then defaults to their count."""
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = bw
        self.p = params
        self.cfg = cfg
        self.freq_fn = freq_fn      # optional per-chunk Doppler freq array fn
        self.block_size = int(block_size)
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import require_one_process
            require_one_process(mesh, f"{type(self).__name__}'s segment scan")
        if n_segments is None and mesh is not None:
            n_segments = int(mesh.shape["time"])
        self.n_segments = int(n_segments) if n_segments else 1
        self.warmup_symbols = int(warmup_symbols)
        self._init_device(device)
        self._useful = 0
        self._syncs = None
        self._dry_run = False
        # pass-2 incremental state
        self._consumed = 0        # minsync events fully absorbed
        self._open = None         # open correlation cluster
        self._prev_lm = None      # lastMin before the open cluster
        self._stale = None        # armed-window buffer left after the arming
        #                           end passed with no trigger (see
        #                           _maybe_snapshot_stale)

    @property
    def useful(self) -> int:
        return self._useful

    # ---------------------------------------------------------------- pass 1
    def _anchors(self, cache: dict, n: int) -> torch.Tensor:
        """Chunk-local NCO anchors of an n-sample chunk (they depend only on
        the chunk length)."""
        if n not in cache:
            cache[n] = torch.as_tensor(nco.phase_anchors(
                self.offset, self.src.sampFreq, 0, n), device=self.device)
        return cache[n]

    def _scan_seq(self, x, state):
        return pll.symbol_scan(self.p, x, state, self.cfg.sym_sync,
                               self.cfg.sym_sync_alt)

    def _scan_seg(self, x, owned_start: int):
        """Segment scan of x; returns the owned symbols in segment order."""
        syms, _, owned = pll.symbol_scan_segments(
            self.p, x, self.cfg.sym_sync, self.cfg.sym_sync_alt,
            self.n_segments, self.warmup_symbols, owned_start, mesh=self.mesh)
        return pll.Symbols(*(t[owned] for t in syms))

    def get_syncs(self) -> list:
        if self._syncs is not None:
            return self._syncs
        p, cfg, dev = self.p, self.cfg, self.device
        fs = self.src.sampFreq
        lp = iir.IirFilter.design_butter(fs, self.bw, order=6, kind="lowpass")
        # the reference's state quirk: the real unit-step zi as complex, so
        # the imaginary row starts from zero
        lp_state = lp.initial_state_step(torch.float32, dev)
        parallel = self.n_segments > 1
        omega = (float(np.float32(-2 * np.pi * self.offset / fs))
                 if self.offset != 0.0 else 0.0)
        plan = plan_blocks(self.src.length, self.block_size)
        anch_cache: dict = {}

        if (self.mesh is None and self.freq_fn is None
                and self.block_size == PROC_CHUNKSIZE
                and self.src.length <= _CAPTURE_SEG_MAX):
            # whole-capture path: unpack, per-chunk NCO, continuous
            # low-pass, then one scan (sequential or capture-level
            # segmented) and one copy of its symbols
            with self._stage("frontend"):
                _, _, x = next(iter(BlockFeeder(self.src, self.src.length, dev)))
                if x.dtype == torch.uint8:
                    x = unpack.iq_u8_to_complex(x)
                if omega != 0.0:
                    x = torch.cat([nco.mix(x[s:e], omega,
                                           self._anchors(anch_cache, e - s))
                                   for (s, e) in plan])
                x_f, _ = lp.apply(x, lp_state)
                del x
            with self._stage("symbol_scan"):
                if parallel:
                    syms = self._scan_seg(x_f, 0)
                else:
                    _, syms = self._scan_seq(
                        x_f, pll.initial_state(p, len(cfg.sym_sync), 1, dev))
            with self._stage("pass2"):
                ai, ph, ch, mf = _host_symbols(syms)
                minsyncs = [(k + 1, int(ai[k])) for k in np.flatnonzero(mf)]
                stream = _DeviceStreamChain()
                stream.append(x_f, 0)
                self._syncs = self._replay_with_view(
                    minsyncs, _DenseSymbols(ai, ph, ch), stream)
            return self._syncs

        scan_state = pll.initial_state(p, len(cfg.sym_sync), 1, dev)
        filt_prefix = torch.zeros(0, dtype=torch.complex64, device=dev)
        warm = int(self.warmup_symbols * p.symbol_period)
        symbols = _GrowingSymbols()
        minsyncs: list = []       # (symbol_number(ctr), global_sample)
        max_syncs: list = []
        stream = _DeviceStreamChain()
        max_win = 2 * (cfg.cap_entries // cfg.entries_per_sample) + 8
        feed = BlockFeeder(self.src, self.block_size, dev)
        for ci, (s, e, x) in enumerate(feed):
            with self._stage("frontend"):
                if x.dtype == torch.uint8:
                    x = unpack.iq_u8_to_complex(x)
                if self.freq_fn is not None:
                    # Doppler path: per-sample frequency track (host)
                    freqs = self.freq_fn(ci, len(plan), e - s)
                    x = nco.mix_array_freq(x, freqs, fs, start=0)
                elif omega != 0.0:
                    # chunk-local NCO phase (reference quirk: no chunker)
                    x = nco.mix(x, omega, self._anchors(anch_cache, e - s))
                x_f, lp_state = lp.apply(x, lp_state)
                del x
            with self._stage("symbol_scan"):
                if parallel:
                    prefix = int(filt_prefix.shape[0])
                    xw = torch.cat([filt_prefix, x_f]) if prefix else x_f
                    syms = self._scan_seg(xw, prefix)
                    filt_prefix = xw[-warm:]
                    shift = s - prefix
                else:
                    scan_state, syms = self._scan_seq(x_f, scan_state)
                    scan_state["i"][:, pll.I_ANCHOR] -= int(x_f.shape[0])
                    shift = s
            with self._stage("pass2"):
                ai, ph, ch, mf = _host_symbols(syms)
                ai = ai + shift
                base_ctr = len(symbols.a)
                symbols.append(ai, ph, ch)
                for k in np.flatnonzero(mf):
                    minsyncs.append((base_ctr + k + 1, int(ai[k])))
                stream.append(x_f, s)
                max_syncs = self._drain_corr_jobs(
                    minsyncs, symbols, stream, stream.lo, stream.hi,
                    max_syncs, final=(ci == len(plan) - 1))
                stream.prune(stream.hi - max_win)

        self._syncs = self._finalize(max_syncs)
        return self._syncs

    # ---------------------------------------------------------------- pass 2
    def _replay_with_view(self, minsyncs, view, stream) -> list:
        """Dry-run the replay to discover the needed windows, gather them
        in one device gather and one copy, then replay for real (the walk's
        control flow never depends on window sample values), and
        finalize."""
        snap = (self._consumed, dict(self._open) if self._open else None,
                self._prev_lm, dict(self._stale) if self._stale else None)
        rec = _RecordingStream(stream)
        self._dry_run = True
        try:
            self._drain_corr_jobs(minsyncs, view, rec, stream.lo, stream.hi,
                                  [], final=True)
        finally:
            self._dry_run = False
        (self._consumed, self._open, self._prev_lm, self._stale) = snap
        cache = _prefetch_windows(stream, rec.ranges)
        max_syncs = self._drain_corr_jobs(
            minsyncs, view, _CachedStream(stream, cache), stream.lo,
            stream.hi, [], final=True)
        return self._finalize(max_syncs)

    def _drain_corr_jobs(self, minsyncs, view, stream, lo, hi, max_syncs,
                         final=False):
        """Advance the arming/countdown state machine over newly seen minsync
        events; run correlations whose countdown completes inside the
        available stream [lo, hi). `view` is the _DenseSymbols of every
        symbol so far, `stream` a _DeviceStreamChain or a stand-in with its
        `lo`, `hi` and `get`."""
        cfg = self.cfg
        eps = cfg.entries_per_sample
        cap_samples = cfg.cap_entries // eps
        countdown = cfg.cap_entries + 1          # samples past the last trigger

        while True:
            if self._open is None:
                if self._consumed >= len(minsyncs):
                    # arming window may have closed with no trigger this
                    # chunk: preserve its buffer for a later-cluster replay
                    self._maybe_snapshot_stale(
                        None, view, stream, lo, hi, cap_samples)
                    break
                ctr_t, samp_t = minsyncs[self._consumed]
                self._maybe_snapshot_stale(
                    ctr_t, view, stream, lo, hi, cap_samples)
                self._consumed += 1
                self._open = {"first": samp_t, "first_ctr": ctr_t,
                              "last": samp_t, "last_ctr": ctr_t,
                              "prev_lm": self._prev_lm}
            # absorb retriggers within the countdown (retain reset,
            # ref decode_funcube.py:294)
            while (self._consumed < len(minsyncs)
                   and minsyncs[self._consumed][1]
                   <= self._open["last"] + countdown):
                ctr_t, samp_t = minsyncs[self._consumed]
                self._consumed += 1
                self._open["last"] = samp_t
                self._open["last_ctr"] = ctr_t
            corr_at = self._open["last"] + countdown
            if corr_at >= hi:
                if final:
                    # capture ended mid-countdown: the reference never
                    # correlates this cluster
                    self._prev_lm = self._open["last_ctr"]
                    self._open = None
                    self._stale = None
                    continue
                break
            prev_lm = self._open["prev_lm"]
            we = corr_at
            past_end = (prev_lm is not None
                        and self._open["first_ctr"]
                        > prev_lm + cfg.arm_end_syms)
            if past_end:
                # the trigger fired AFTER the arming window closed
                # (ref decode_funcube.py:241's end clause): the reference's
                # buffer then holds the STALE tail of the closed armed
                # window plus the fresh countdown samples after the trigger,
                # and it reports maxBuffStart + argmax over that
                # discontiguous buffer as if it were contiguous -- kept.
                fresh_ws = max(self._open["first"] + 1, lo)
                vals = self._quantize_window(
                    stream.get(fresh_ws, we + 1), fresh_ws, view)
                report_ws = fresh_ws
                if self._stale is not None:
                    vals = np.concatenate([self._stale["vals"], vals])
                    report_ws = self._stale["ws"]
            else:
                # window start: pre-trigger sliding buffer begins at the
                # arming boundary of the *previous* frame's lastMin, capped
                # to the buffer size (ref decode_funcube.py:240-249)
                ws = self._open["first"] + 1
                if prev_lm is not None:
                    arm_samp = view.sym_sample(prev_lm + cfg.arm_pre_syms)
                    if arm_samp is not None and arm_samp + 1 < ws:
                        ws = max(arm_samp + 1,
                                 self._open["first"] + 1 - cap_samples)
                ws = max(ws, lo)
                vals = self._quantize_window(
                    stream.get(ws, we + 1), ws, view)
                report_ws = ws
            needle_i = 0
            if len(cfg.needles) > 1:
                needle_i = view.chosen_before(we)
            sync_pos = self._correlate_vals(vals, report_ws,
                                            cfg.needles[needle_i])
            max_syncs.append(sync_pos)
            log.info("MAXSYNC %s", sync_pos)
            self._prev_lm = self._open["last_ctr"]
            self._open = None
            self._stale = None
        return max_syncs

    def _maybe_snapshot_stale(self, next_ctr, view, stream, lo, hi,
                              cap_samples):
        """Capture the sliding buffer of an armed window that closed with no
        trigger (ref decode_funcube.py:240-241: buffering stops once
        ctr > lastMin + arm_end_syms but maxResBuff is only cleared by a
        correlation, so its last `cap` samples survive until the next
        trigger). Called with `next_ctr` = the next pending trigger's symbol
        count (None at chunk end when no trigger is pending)."""
        cfg = self.cfg
        if self._stale is not None or self._prev_lm is None:
            return
        boundary = self._prev_lm + cfg.arm_end_syms
        if next_ctr is not None and next_ctr <= boundary:
            return                      # window got a trigger: no stale buffer
        end_samp = view.sym_sample(boundary)
        if end_samp is None or end_samp >= hi:
            return                      # window still open / not streamed yet
        arm_samp = view.sym_sample(self._prev_lm + cfg.arm_pre_syms)
        ws = end_samp + 1 - cap_samples
        if arm_samp is not None:
            ws = max(ws, arm_samp + 1)
        ws = max(ws, lo)
        if ws > end_samp:
            return
        self._stale = {
            "ws": ws,
            "vals": self._quantize_window(
                stream.get(ws, end_samp + 1), ws, view)}

    def _quantize_window(self, seg: np.ndarray, ws: int, view) -> np.ndarray:
        """Rotate by the PLL phasor and quantize like the reference
        (ref decode_funcube.py:243 `lim(real(i*pllObj.output)/2)`)."""
        cfg = self.cfg
        n_arr = ws + np.arange(len(seg))
        ph = view.phase_at(n_arr)
        rot = seg * np.exp(-1j * ph)
        if cfg.entries_per_sample == 1:
            return _lim(np.real(rot) / 2.0)
        vals = np.empty(2 * len(seg))
        vals[0::2] = _lim(np.real(rot) / 2.0)
        vals[1::2] = _lim(np.imag(rot) / 2.0)
        return vals

    def _correlate_vals(self, vals: np.ndarray, report_ws: int,
                        needle: np.ndarray) -> float:
        """|correlate('same')| argmax, reported as maxBuffStart + argmax
        (ref decode_funcube.py:253-255), as a host FFT. During a dry-run
        replay (window discovery) the result is unused: skipped."""
        if self._dry_run:
            return float(report_ws)
        n, k = len(vals), len(needle)
        m = 1 << max(n + k - 1, 2).bit_length()
        full = np.fft.irfft(np.fft.rfft(vals, m)
                            * np.fft.rfft(needle[::-1], m), m)[: n + k - 1]
        cor = np.abs(full[(k - 1) // 2: (k - 1) // 2 + n])
        am = int(np.argmax(cor))
        if self.cfg.entries_per_sample == 1:
            return float(report_ws + am)
        return float(report_ws + am / 2.0)

    def _finalize(self, max_syncs: list) -> list:
        cfg = self.cfg
        if max_syncs:
            d = np.abs(np.diff(max_syncs) - cfg.frame_spacing)
            if len(d) and np.min(d) < cfg.spacing_tol:
                self._useful = 1
            return list(max_syncs)[1:]
        return []
