"""Funcube/Meteor frame-sync detection: chunk loop + two-pass max-sync search.

Port of `directdemod_tpu/models/psk_sync.py`. The reference interleaves,
per sample: (1) conditional buffering of PLL-rotated samples near expected
frame positions, (2) a correlation countdown, (3) Gardner/AGC/Costas symbol
processing with rolling-buffer "minsync" detection. Here, as in the JAX
package, in two passes:

  pass 1 (the decoder's device): unpack, chunk-local NCO, the continuous
  Butterworth low-pass of the complex stream, and the symbol-rate scan
  (`ops/pll`, K3 on a card), sequential or segment-parallel;
  pass 2: the per-sample buffering and countdown replayed on the host over
  the symbol -> sample map (`_Pass2._walk`), which emits each frame's
  correlation as a job of sample ranges; then one batched chain a block on
  the decoder's device (`_Pass2._run`) gathers the block's windows from the
  filtered stream (kept on the device), rotates them by the piecewise-
  constant PLL phasor, quantizes them and correlates them with the needles
  in float64. The syncs stay on the device until the decode ends.

The NCO phase restarts at every chunk and the low-pass carries state across
chunks: both reference quirks are kept. Where the JAX package has two
dispatch shapes, `get_syncs` has two block plans, one loop: the whole
capture as one block (up to `_CAPTURE_SEG_MAX` samples, default block size,
no Doppler track, no mesh), or one block a chunk. The A indices of the valid
symbols come to the host in one copy per scan (8 B a symbol), their phases
and needle choices stay on the device; the JAX package's sparse
event/span gathers, its event cap and its `_CoverageError` fallback existed
for its device link and are not ported (its sparse path is pinned equal to
the dense one). With `mesh=` (`parallel.mesh`) the segment scan runs over
the mesh's `time` shards (`pll.symbol_scan_segments(mesh=)`, one K3 launch
a shard), in the block loop, as the JAX decoder does.
"""
from __future__ import annotations

import bisect
import logging
from dataclasses import dataclass, field

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
    the decoder's device, each with its global first sample. `gather`
    reads windows out of the blocks in place; a window may straddle block
    boundaries."""

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

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """The samples at the global indices `idx` (a device tensor of any
        shape, inside [lo, hi) where it matters: others read a clamped
        neighbour), one gather from each block."""
        arr, lo = self.segs[-1]
        out = arr[(idx - lo).clamp(0, int(arr.shape[0]) - 1)]
        for arr, lo in self.segs[-2::-1]:
            n = int(arr.shape[0])
            out = torch.where(idx < lo + n, arr[(idx - lo).clamp(0, n - 1)], out)
        return out

    def prune(self, keep_from: int) -> None:
        """Drop whole blocks that end at or before `keep_from`."""
        self.segs = [(arr, lo) for (arr, lo) in self.segs
                     if lo + int(arr.shape[0]) > keep_from]


class _SymbolStore:
    """Pass 2's view of the scans' symbols, in symbol order. The host holds
    every block's A sample indices (the arming walk reads them through
    `sym_sample`) with the count of symbols before the block. The device
    holds the A indices, PLL phases and needle choices of the blocks whose
    symbols a window may still read, and the phase and choice of the last
    symbol before them (`table`)."""

    def __init__(self):
        self.count = 0
        self._bases: list = []     # symbols before each block
        self._host: list = []      # each block's A indices, numpy int64
        self._dev: list = []       # [(last A index or None, a, ph, ch)]
        self._carry = None         # (ph, ch) of the last symbol dropped

    def append(self, a: torch.Tensor, ph: torch.Tensor,
               ch: torch.Tensor) -> np.ndarray:
        """Add a block's symbols (global A indices, phases, choices);
        returns its A indices on the host (one copy)."""
        host = a.cpu().numpy()
        self._bases.append(self.count)
        self._host.append(host)
        self.count += len(host)
        self._dev.append((int(host[-1]) if len(host) else None, a, ph,
                          ch.to(torch.int64)))
        return host

    def sym_sample(self, j: int):
        """Global sample of 0-based symbol j (ctr becomes j+1 there); None
        past the symbols so far."""
        if not 0 <= j < self.count:
            return None
        b = bisect.bisect_right(self._bases, j) - 1
        return int(self._host[b][j - self._bases[b]])

    def prune(self, lo: int) -> None:
        """Drop the device arrays of the leading blocks whose symbols all
        lie before sample `lo`, keeping the last one's phase and choice."""
        while self._dev and (self._dev[0][0] is None or self._dev[0][0] < lo):
            last, _, ph, ch = self._dev.pop(0)
            if last is not None:
                self._carry = (ph[-1:], ch[-1:])

    def table(self, device) -> tuple:
        """(A indices, phases, choices) on the device, the phases and
        choices led by the last dropped symbol's (0 and 0 before any):
        row `searchsorted(a, n)` of them is then the last symbol's with A
        index < n, the phase in effect at sample n (pllObj.output is updated
        when a symbol processes -- ref decode_funcube.py:61) and the needle
        chosen before it."""
        ph0, ch0 = self._carry or (
            torch.zeros(1, dtype=torch.float32, device=device),
            torch.zeros(1, dtype=torch.int64, device=device))
        a = [d[1] for d in self._dev]
        a = a[0] if len(a) == 1 else torch.cat(
            a or [torch.zeros(0, dtype=torch.int64, device=device)])
        return (a, torch.cat([ph0] + [d[2] for d in self._dev]),
                torch.cat([ch0] + [d[3] for d in self._dev]))


@dataclass(eq=False)
class _Window:
    """Samples [a, b) of the filtered stream, rotated and quantized in the
    device batch of the block that gathers them. A stale snapshot (`keep`)
    holds its entries in `vals` for a later batch, since its samples may be
    pruned before the job that reads them runs."""
    a: int
    b: int
    keep: bool = False
    vals: torch.Tensor | None = field(default=None, repr=False)


@dataclass(eq=False)
class _Job:
    """One frame correlation: the entries of its windows joined in order (a
    past-end job: the stale snapshot, then the fresh samples), reported as
    `report_ws` + argmax, with the needle chosen before sample `we`."""
    parts: list
    report_ws: int
    we: int


def _lim(x: torch.Tensor) -> torch.Tensor:
    """ref decode_funcube.py:88-97: clamp to [-128,127], values in (0,1)->1,
    (-1,0)->-1, else int truncation (those are the values that truncate to
    zero without being zero: their sign)."""
    t = torch.trunc(x)
    return torch.where(t == 0, torch.sign(x), t).clamp(-128, 127)


def _to_device(host: np.ndarray, device) -> torch.Tensor:
    """A host array on `device` without waiting for the device's queue: a
    pinned, non-blocking copy on a card."""
    t = torch.from_numpy(host)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


@dataclass
class _SyncConfig:
    sym_sync: np.ndarray        # 0/1 pattern at symbol rate (buffer compare)
    sym_sync_alt: np.ndarray    # QPSK alternate (== sym_sync for BPSK)
    needles: list               # +-128-valued full-rate needles (1 or 3), of
    #                             one length
    entries_per_sample: int     # 1 bpsk, 2 qpsk (interleaved I/Q)
    cap_entries: int            # maxResBuff cap (2 * len(needle))
    arm_pre_syms: int           # arming starts at ctr > lastMin + this
    arm_end_syms: int           # arming ends past ctr > lastMin + this
    frame_spacing: float        # expected sync spacing (samples)
    spacing_tol: float          # usefulness tolerance (samples)


class _Pass2:
    """Pass 2 of one decode, fed block by block (`add_block`): the arming
    and countdown walk on the host (`_walk`), which emits a job a frame
    correlation, and one device batch a block that runs the block's jobs
    (`_run`). The syncs collect on the device; `syncs` copies them to the
    host once. `dec` is the decoder: its `cfg`, `device`, spans and
    counters."""

    def __init__(self, dec: "PskSyncDetector"):
        self.dec = dec
        self.cfg = cfg = dec.cfg
        self.device = dec.device
        self.stream = _DeviceStreamChain()
        self.symbols = _SymbolStore()
        self.minsyncs: list = []    # (symbol_number(ctr), global_sample)
        # a window reaches at most this far before the retained stream's end
        self.max_win = 2 * (cfg.cap_entries // cfg.entries_per_sample) + 8
        self.found: list = []       # float64 device tensors of syncs
        self._needles = None        # reversed needles, float64 on the device
        self._spectra: dict = {}    # FFT size -> the needles' spectra
        # the walk's state
        self._consumed = 0          # minsync events fully absorbed
        self._open = None           # open correlation cluster
        self._prev_lm = None        # lastMin before the open cluster
        self._stale = None          # _Window of the armed-window buffer left
        #                             after the arming end passed with no
        #                             trigger (see _snapshot_stale)

    def add_block(self, x_f: torch.Tensor, start: int, syms: pll.Symbols,
                  shift: int, final: bool) -> None:
        """Feed one block: its filtered samples from global sample `start`
        and its scan's symbols, whose A indices are `shift` less than
        global ones. `final`: the capture ends with the block."""
        dec = self.dec
        with dec._span("pass2.symbols"):
            base = self.symbols.count
            a = self.symbols.append(syms.a_idx + shift, syms.phase_out,
                                    syms.chosen)
            new = np.flatnonzero(syms.minsync.cpu().numpy())
            self.minsyncs += [(base + k + 1, int(a[k])) for k in new]
        dec._count("pass2.minsyncs", len(new))
        self.stream.append(x_f, start)
        self._walk(self.stream.lo, self.stream.hi, final)
        self.stream.prune(self.stream.hi - self.max_win)
        self.symbols.prune(self.stream.lo)

    def syncs(self) -> list:
        """Every sync found so far, in order: one copy to the host."""
        return torch.cat(self.found).tolist() if self.found else []

    # ------------------------------------------------------------ the walk
    def _walk(self, lo: int, hi: int, final: bool) -> None:
        """Advance the arming/countdown state machine over newly seen minsync
        events; a correlation whose countdown completes inside the
        available stream [lo, hi) becomes a job. The walk reads only the
        symbols' A indices, never window values; the block's jobs then run
        in one device batch."""
        cfg = self.cfg
        cap_samples = cfg.cap_entries // cfg.entries_per_sample
        countdown = cfg.cap_entries + 1          # samples past the last trigger
        minsyncs = self.minsyncs
        windows: list = []
        jobs: list = []

        while True:
            if self._open is None:
                if self._consumed >= len(minsyncs):
                    # arming window may have closed with no trigger this
                    # chunk: preserve its buffer for a later-cluster replay
                    self._snapshot_stale(None, lo, hi, cap_samples, windows)
                    break
                ctr_t, samp_t = minsyncs[self._consumed]
                self._snapshot_stale(ctr_t, lo, hi, cap_samples, windows)
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
                fresh = _Window(max(self._open["first"] + 1, lo), we + 1)
                windows.append(fresh)
                job = _Job([fresh], fresh.a, we)
                if self._stale is not None:
                    job = _Job([self._stale, fresh], self._stale.a, we)
            else:
                # window start: pre-trigger sliding buffer begins at the
                # arming boundary of the *previous* frame's lastMin, capped
                # to the buffer size (ref decode_funcube.py:240-249)
                ws = self._open["first"] + 1
                if prev_lm is not None:
                    arm_samp = self.symbols.sym_sample(
                        prev_lm + cfg.arm_pre_syms)
                    if arm_samp is not None and arm_samp + 1 < ws:
                        ws = max(arm_samp + 1,
                                 self._open["first"] + 1 - cap_samples)
                win = _Window(max(ws, lo), we + 1)
                windows.append(win)
                job = _Job([win], win.a, we)
            jobs.append(job)
            self._prev_lm = self._open["last_ctr"]
            self._open = None
            self._stale = None
        self._run(windows, jobs)

    def _snapshot_stale(self, next_ctr, lo, hi, cap_samples, windows) -> None:
        """Capture the sliding buffer of an armed window that closed with no
        trigger (ref decode_funcube.py:240-241: buffering stops once
        ctr > lastMin + arm_end_syms but maxResBuff is only cleared by a
        correlation, so its last `cap` samples survive until the next
        trigger). Called with `next_ctr` = the next pending trigger's symbol
        count (None at chunk end when no trigger is pending). The snapshot
        is a window of this block's batch."""
        cfg = self.cfg
        if self._stale is not None or self._prev_lm is None:
            return
        boundary = self._prev_lm + cfg.arm_end_syms
        if next_ctr is not None and next_ctr <= boundary:
            return                      # window got a trigger: no stale buffer
        end_samp = self.symbols.sym_sample(boundary)
        if end_samp is None or end_samp >= hi:
            return                      # window still open / not streamed yet
        arm_samp = self.symbols.sym_sample(self._prev_lm + cfg.arm_pre_syms)
        ws = end_samp + 1 - cap_samples
        if arm_samp is not None:
            ws = max(ws, arm_samp + 1)
        ws = max(ws, lo)
        if ws > end_samp:
            return
        self._stale = _Window(ws, end_samp + 1, keep=True)
        windows.append(self._stale)

    # -------------------------------------------------------- the executor
    def _run(self, windows: list, jobs: list) -> None:
        """One device batch: gather, rotate and quantize every window of the
        block (the span `psk.pass2.window`), then correlate every job with
        its needle (`psk.pass2.correlate`). Nothing here waits for the
        device: the jobs' plan goes over in one non-blocking copy and the
        syncs stay on the device."""
        if not windows:
            return
        dec, dev = self.dec, self.device
        eps = self.cfg.entries_per_sample
        dec._count("pass2.windows", len(windows))
        n_w = len(windows)
        rows = {id(w): r for r, w in enumerate(windows)}
        lq = eps * max(w.b - w.a for w in windows)
        # each job's entries are pool[first + t], and pool[first + t + jump]
        # from its second part on (at `split`), for t < its length: the pool
        # is the batch's quantized windows, then stale snapshots of past
        # batches
        extras, off, lv = [], n_w * lq, 0
        plan = [w.a for w in windows]
        for job in jobs:
            parts = []
            for w in job.parts:
                if id(w) in rows:
                    parts.append((rows[id(w)] * lq, eps * (w.b - w.a)))
                else:
                    extras.append(w.vals)
                    parts.append((off, int(w.vals.shape[0])))
                    off += parts[-1][1]
            (first, split), (second, _) = parts[0], parts[-1]
            length = sum(n for _, n in parts)
            lv = max(lv, length)
            plan += [first, split, second - first - split, length,
                     job.report_ws, job.we]
        plan = _to_device(np.asarray(plan, dtype=np.int64), dev)
        table = self.symbols.table(dev)
        with dec._span("pass2.window"):
            q = self._quantize(plan[:n_w], lq // eps, table)
            for r, w in enumerate(windows):
                if w.keep:
                    w.vals = q[r, :eps * (w.b - w.a)].clone()
            if not jobs:
                return
            jp = plan[n_w:].view(len(jobs), 6)
            t = torch.arange(lv, device=dev)
            idx = jp[:, 0:1] + t + (t >= jp[:, 1:2]) * jp[:, 2:3]
            pool = torch.cat([q.reshape(-1)] + extras) if extras else q.reshape(-1)
            inside = t < jp[:, 3:4]
            v = torch.where(inside, pool[idx.clamp(0, pool.numel() - 1)], 0.0)
        dec._count("pass2.batches", 1)
        dec._count("pass2.correlations", len(jobs))
        with dec._span("pass2.correlate"):
            self.found.append(self._correlate(
                v, inside, jp[:, 4], jp[:, 5].contiguous(), table))

    def _quantize(self, starts, n: int, table) -> torch.Tensor:
        """n samples of the stream from each of `starts`, rotated by the PLL
        phasor in effect at each sample and quantized like the reference
        (ref decode_funcube.py:243 `lim(real(i*pllObj.output)/2)`), I and Q
        interleaved for QPSK: (windows, n * entries_per_sample) float64.
        Entries past a window's own end are not its own: callers read each
        row's window alone."""
        a_tab, ph_tab, _ = table
        idx = starts[:, None] + torch.arange(n, device=starts.device)
        rot = self.stream.gather(idx) * torch.exp(
            -1j * ph_tab[torch.searchsorted(a_tab, idx)])
        if self.cfg.entries_per_sample == 1:
            q = _lim(rot.real / 2.0)
        else:
            q = _lim(torch.view_as_real(rot) / 2.0).reshape(len(idx), -1)
        return q.to(torch.float64)

    def _correlate(self, v, inside, report_ws, we, table) -> torch.Tensor:
        """|correlate(v, needle, 'same')| first argmax of each row, reported
        as maxBuffStart + argmax (ref decode_funcube.py:253-255), half an
        entry a sample for QPSK: a float64 FFT, zero-padded to the power of
        two the batch's longest row needs. Rows and needles are whole
        numbers, so the correlation is too: rounding it removes the FFT's
        error (far below 0.5 at these lengths) and leaves ties to the first
        index, as np.correlate's exact sums do."""
        cfg, dev = self.cfg, self.device
        k = len(cfg.needles[0])
        lv = int(v.shape[1])
        m = 1 << (lv + k - 2).bit_length()
        if self._needles is None:
            self._needles = _to_device(
                np.stack([np.asarray(nd, np.float64)[::-1] for nd in cfg.needles]),
                dev)
        if m not in self._spectra:
            self._spectra[m] = torch.fft.rfft(self._needles, m)
        spec = self._spectra[m]
        if len(cfg.needles) > 1:
            a_tab, _, ch_tab = table
            spec = spec[ch_tab[torch.searchsorted(a_tab, we)]]
        full = torch.fft.irfft(torch.fft.rfft(v, m) * spec, m)
        h = (k - 1) // 2
        cor = torch.where(inside, full[:, h:h + lv].abs().round(), -1.0)
        am = cor.argmax(dim=1)
        return (report_ws.to(torch.float64)
                + am.to(torch.float64) / cfg.entries_per_sample)


class PskSyncDetector(TimedDecoder):
    """Shared decoder; see FuncubeDecoder / MeteorM2Decoder for the configs.
    `device` and `stage_seconds` (`frontend`, `symbol_scan`, `pass2`) as
    `TimedDecoder` gives them. Pass 2's spans: `psk.pass2.symbols` (a
    scan's A indices and minsync flags to the host and into the symbol
    store, counting `psk.pass2.minsyncs`), `psk.pass2.window` (a block's
    batch gathering, rotating and quantizing its windows on the device,
    counting `psk.pass2.windows`, stale snapshots included) and
    `psk.pass2.correlate` (the batch's frame correlations on the device,
    counting `psk.pass2.correlations`, and the batch in
    `psk.pass2.batches`). The symbol scan counts `psk.symbol_scan.symbols`;
    for a sequential scan that the step budget stopped with samples left,
    `psk.symbol_scan.budget_stops` and `psk.symbol_scan.samples_left`; and
    for a sequential scan on the card, `psk.symbol_scan.window_misses` and
    `psk.symbol_scan.sincos_fallbacks` (`_count_scan`)."""

    layer = "psk"

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

    def _count_scan(self, syms: pll.Symbols, n: int) -> None:
        """Count a sequential scan of an n-sample block: its symbols; where
        the step budget stopped it with samples left (the scan's own flag,
        `pll.LAST_TRUNCATED`), the stop and the samples after its last A
        index; and, where K3 ran it (`pll.LAST_STATS`), the samples its
        stage P read from device memory and the steps where its stage C ran
        the full sincos."""
        self._count("symbol_scan.symbols", syms.count)
        if pll.LAST_STATS is not None:
            self._count("symbol_scan.window_misses", sum(pll.LAST_STATS["window_misses"]))
            self._count("symbol_scan.sincos_fallbacks",
                        sum(pll.LAST_STATS["sincos_fallbacks"]))
        if pll.LAST_TRUNCATED:
            self._count("symbol_scan.budget_stops", 1)
            self._count("symbol_scan.samples_left",
                        n - 1 - int(syms.a_idx[-1].item()))

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
        omega = (float(np.float32(-2 * np.pi * self.offset / fs))
                 if self.offset != 0.0 else 0.0)
        # two block plans, one loop (the module's docstring)
        n = self.src.length
        whole = (self.mesh is None and self.freq_fn is None
                 and self.block_size == PROC_CHUNKSIZE and n <= _CAPTURE_SEG_MAX)
        plan = [(0, n)] if whole else plan_blocks(n, self.block_size)
        anch_cache: dict = {}
        pass2 = _Pass2(self)
        scan_state = pll.initial_state(p, len(cfg.sym_sync), 1, dev)
        filt_prefix = torch.zeros(0, dtype=torch.complex64, device=dev)
        warm = int(self.warmup_symbols * p.symbol_period)
        feed = BlockFeeder(self.src, device=dev, blocks=plan)
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
                    parts = [nco.mix(x[a:b], omega,
                                     self._anchors(anch_cache, b - a))
                             for a, b in plan_blocks(e - s, self.block_size)]
                    x = parts[0] if len(parts) == 1 else torch.cat(parts)
                with self._span("frontend.lowpass"):
                    x_f, lp_state = lp.apply(x, lp_state)
                del x
            with self._stage("symbol_scan"):
                if self.n_segments > 1:
                    prefix = int(filt_prefix.shape[0])
                    xw = torch.cat([filt_prefix, x_f]) if prefix else x_f
                    syms = self._scan_seg(xw, prefix)
                    self._count("symbol_scan.symbols", syms.count)
                    filt_prefix = xw[-warm:]
                    shift = s - prefix
                else:
                    scan_state, syms = self._scan_seq(x_f, scan_state)
                    self._count_scan(syms, int(x_f.shape[0]))
                    scan_state["i"][:, pll.I_ANCHOR] -= int(x_f.shape[0])
                    shift = s
            with self._stage("pass2"):
                last = ci == len(plan) - 1
                pass2.add_block(x_f, s, syms, shift, final=last)
                if last:
                    self._syncs = self._finalize(pass2.syncs())

        if self._syncs is None:                 # an empty capture
            self._syncs = self._finalize([])
        return self._syncs

    def _finalize(self, max_syncs: list) -> list:
        """Usefulness from the spacing of every sync found, and the syncs
        after the first."""
        cfg = self.cfg
        for s in max_syncs:
            log.info("MAXSYNC %s", s)
        if max_syncs:
            d = np.abs(np.diff(max_syncs) - cfg.frame_spacing)
            if len(d) and np.min(d) < cfg.spacing_tol:
                self._useful = 1
            return list(max_syncs)[1:]
        return []
