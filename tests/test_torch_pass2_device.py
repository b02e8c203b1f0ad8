"""Pass 2's device batch (`models/psk_sync._Pass2._run`) against a plain
NumPy oracle, on the CPU, and a guard on its host traffic.

The oracle rotates and quantizes each window in NumPy as the JAX
package's `PskSyncDetector._quantize_window` does (`seg * np.exp(-1j *
phase)` in complex64, the phase of the last symbol before each sample,
`lim(real / 2)` and, for QPSK, `lim(imag / 2)` interleaved), joins a
past-end job's stale and fresh parts, and takes
`np.argmax(np.abs(np.correlate(vals, needle, 'same')))` with the needle
chosen before the job's end, reported as the window start plus the argmax
(half an entry a sample for QPSK).

Stated checks: syncs equal (both sides correlate whole numbers: the
oracle's sums are exact, the batch rounds its float64 FFT); quantized
entries equal but for at most one in a thousand that differs by one (NumPy
may fuse the complex64 product's multiply-add where PyTorch rounds each
product, so a value within an ulp of a whole number truncates either way).
The guard decodes through the block loop with every host copy and
synchronising call of a tensor made to raise inside the batch, and counts
them per block outside it.
"""
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from benchmarks.synth import qpsk as qsynth
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models import psk_sync
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6000                 # samples of the test stream
SPLIT = 2500             # first sample of its second block
K = 40                   # needle entries


def _np_lim(x):
    out = np.trunc(x)
    out = np.where((x > 0) & (x < 1), 1, out)
    out = np.where((x > -1) & (x < 0), -1, out)
    return np.clip(out, -128, 127)


class _Scene:
    """A two-block stream with its symbols (random phases and needle
    choices), 1 or 3 needles, and the oracle."""

    def __init__(self, eps, n_needles, seed):
        rng = np.random.default_rng(seed)
        self.eps = eps
        self.needles = [np.where(rng.integers(0, 2, K) == 1, 127.0, -128.0)
                        for _ in range(n_needles)]
        self.a = np.arange(5, N, 7, dtype=np.int64)
        self.ph = rng.uniform(-np.pi, np.pi, len(self.a)).astype(np.float32)
        self.ch = rng.integers(0, n_needles, len(self.a)).astype(np.int64)
        self.x = ((rng.normal(size=N) + 1j * rng.normal(size=N)) * 30.0
                  ).astype(np.complex64)

    def phase_at(self, n):
        pos = np.searchsorted(self.a, n, side="left") - 1
        return np.where(pos >= 0, self.ph[np.clip(pos, 0, None)], 0.0)

    def chosen_before(self, n):
        pos = np.searchsorted(self.a, n, side="left") - 1
        return int(self.ch[pos]) if pos >= 0 else 0

    def choose(self, we, i):
        """Make needle i the one chosen before sample `we`."""
        self.ch[np.searchsorted(self.a, we, side="left") - 1] = i

    def plant(self, start, i):
        """Plant needle i from sample `start` so that it survives the
        rotation: 0.8 of its level after quantization."""
        nd = 0.8 * self.needles[i]
        n = len(nd) // self.eps
        pos = np.arange(start, start + n)
        want = 2 * (nd if self.eps == 1 else nd[0::2] + 1j * nd[1::2])
        self.x[pos] = (want * np.exp(1j * self.phase_at(pos))).astype(np.complex64)

    def vals(self, a, b):
        """Samples [a, b) rotated and quantized, as `_quantize_window`."""
        seg = self.x[a:b]
        rot = seg * np.exp(-1j * self.phase_at(a + np.arange(b - a)))
        if self.eps == 1:
            return _np_lim(np.real(rot) / 2.0)
        v = np.empty(2 * len(seg))
        v[0::2] = _np_lim(np.real(rot) / 2.0)
        v[1::2] = _np_lim(np.imag(rot) / 2.0)
        return v

    def sync(self, parts, we):
        vals = np.concatenate([self.vals(a, b) for a, b in parts])
        needle = self.needles[self.chosen_before(we)]
        am = int(np.argmax(np.abs(np.correlate(vals, needle, "same"))))
        return float(parts[0][0] + am) if self.eps == 1 else \
            float(parts[0][0] + am / 2.0)

    def pass2(self):
        """A detector on the CPU and its pass 2, holding both blocks."""
        det = object.__new__(psk_sync.PskSyncDetector)
        det.cfg = psk_sync._SyncConfig(
            sym_sync=np.zeros(4), sym_sync_alt=np.zeros(4),
            needles=self.needles, entries_per_sample=self.eps,
            cap_entries=2 * K, arm_pre_syms=0, arm_end_syms=0,
            frame_spacing=1e9, spacing_tol=1.0)
        det._init_device("cpu")
        p2 = psk_sync._Pass2(det)
        for lo, hi in ((0, SPLIT), (SPLIT, N)):
            sel = (self.a >= lo) & (self.a < hi)
            p2.symbols.append(*(torch.from_numpy(v[sel])
                                for v in (self.a, self.ph, self.ch)))
            p2.stream.append(torch.from_numpy(self.x[lo:hi]), lo)
        return det, p2


def _same_entries(got, want):
    """Quantized entries equal, but for at most one in a thousand (and one
    in any case) that differs by one."""
    diff = np.abs(np.asarray(got, np.float64) - want)
    assert len(got) == len(want)
    assert diff.max() <= 1 and np.count_nonzero(diff) <= max(1, 1e-3 * len(want))


def _job(p2, parts, we):
    """A job over the windows `parts` ((a, b) ranges or stale _Windows);
    returns it and its new windows."""
    ws = [w if isinstance(w, psk_sync._Window) else psk_sync._Window(*w)
          for w in parts]
    new = [w for w, p in zip(ws, parts) if not isinstance(p, psk_sync._Window)]
    return psk_sync._Job(ws, ws[0].a, we), new


# (entries per sample, needles, batches: each a list of jobs, a job its
# windows[, the needle's offset into the job's first window]). A window is
# (a, b); "stale" a snapshot taken in that batch, "+stale" a job that reads
# it first.
CASES = {
    # one batch, windows of three lengths
    "bpsk_lengths": (1, 1, [[[(100, 400)], [(700, 1217)], [(1400, 1528)]]]),
    # three needles, each chosen once, windows of two lengths
    "qpsk_needles": (2, 3, [[[(100, 350)], [(500, 900)], [(1100, 1350)]]]),
    # a window across the two retained blocks
    "straddle": (2, 3, [[[(2300, 2800)], [(3000, 3200)]]]),
    # a batch with no job between two batches with jobs
    "no_job": (1, 1, [[[(200, 600)]], [], [[(3000, 3400)]]]),
    # a past-end job: the stale snapshot gathered in the first batch, its
    # block pruned, the fresh samples in the second
    "past_end": (1, 1, [[[(300, 520)], "stale"], [["+stale", (2600, 2900)]]]),
    "past_end_qpsk": (2, 3, [["stale"], [["+stale", (3100, 3300)]]]),
    # the same with the needle in the fresh part (sample 1800 + 850)
    "past_end_fresh": (1, 1, [[[(300, 520)], "stale"],
                              [["+stale", (2600, 2900), 850]]]),
    # a short window whose needle runs past its end, beside a longer one:
    # the best alignment lies past the short row's 'same' range
    "needle_past_end": (1, 1, [[[(100, 400)], [(700, 760), 45]]]),
}
STALE = (1800, 2100)


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_matches_numpy_oracle(case):
    eps, n_needles, batches = CASES[case]
    sc = _Scene(eps, n_needles, seed=sorted(CASES).index(case))
    # plant each job's needle (in its first part: a stale part for a
    # past-end job, so that the argmax lands there) and make it the chosen one
    i = 0
    for batch in batches:
        for spec in batch:
            if spec == "stale":
                continue
            parts = [STALE if p in ("stale", "+stale") else p for p in spec
                     if not isinstance(p, int)]
            offset = spec[-1] if isinstance(spec[-1], int) else 37
            sc.choose(parts[-1][1] - 1, i % n_needles)
            sc.plant(parts[0][0] + offset, i % n_needles)
            i += 1
    det, p2 = sc.pass2()
    stale, want = None, []
    for bi, batch in enumerate(batches):
        windows, jobs = [], []
        for spec in batch:
            if spec == "stale":
                stale = psk_sync._Window(*STALE, keep=True)
                windows.append(stale)
                continue
            spec = [p for p in spec if not isinstance(p, int)]
            parts = [stale if p == "+stale" else p for p in spec]
            job, new = _job(p2, parts, parts[-1][1] - 1)
            windows += new
            jobs.append(job)
            want.append(sc.sync([STALE if p == "+stale" else p for p in spec],
                                job.we))
        p2._run(windows, jobs)
        if bi == 0 and stale is not None:
            # the snapshot's block leaves the retained stream and the
            # device's symbol table: only its quantized entries remain
            p2.stream.prune(SPLIT + 1)
            p2.symbols.prune(p2.stream.lo)
            assert p2.stream.lo == SPLIT and stale.vals is not None
            _same_entries(stale.vals.numpy(), sc.vals(*STALE))
    assert p2.syncs() == want
    n_batches = sum(1 for b in batches if [s for s in b if s != "stale"])
    assert det.counters["psk.pass2.batches"] == n_batches
    assert det.counters["psk.pass2.correlations"] == len(want)


@pytest.mark.parametrize("eps", [1, 2])
def test_quantized_windows_match_numpy(eps):
    """Every entry of windows across both blocks, the first symbol's phase
    carried for samples before a block's first symbol."""
    sc = _Scene(eps, 3 if eps == 2 else 1, seed=11 + eps)
    _, p2 = sc.pass2()
    ranges = [(0, 900), (2000, 3100), (2495, 2510), (5000, N)]
    starts = torch.tensor([a for a, _ in ranges])
    n = max(b - a for a, b in ranges)
    q = p2._quantize(starts, n, p2.symbols.table("cpu")).numpy()
    assert q.dtype == np.float64 and q.shape == (len(ranges), eps * n)
    for row, (a, b) in zip(q, ranges):
        want = sc.vals(a, b)
        _same_entries(row[:len(want)], want)
    # the first block's symbols leave the device's table: samples before
    # the second block's first symbol take its last symbol's phase
    p2.symbols.prune(SPLIT)
    a0 = int(sc.a[sc.a >= SPLIT][0])
    assert a0 > SPLIT
    q = p2._quantize(torch.tensor([SPLIT]), 40, p2.symbols.table("cpu")).numpy()
    _same_entries(q[0], sc.vals(SPLIT, SPLIT + 40))


# ------------------------------------------------------------------ guard

_HOST = ("cpu", "numpy", "item", "tolist", "nonzero", "__array__", "__bool__",
         "__int__", "__float__", "__index__")


@pytest.fixture
def host_guard(monkeypatch):
    """Makes every tensor method that copies to the host or waits for the
    device raise inside `_Pass2._run`, and counts their calls elsewhere in
    `_Pass2.add_block`, block by block."""
    state = {"in_run": False, "in_block": False, "per_block": [], "syncs": 0}

    def guard(name, orig):
        def call(self, *args, **kwargs):
            if state["in_run"]:
                raise AssertionError(f"Tensor.{name} inside pass 2's batch")
            if state["in_block"]:
                state["per_block"][-1] += 1
            return orig(self, *args, **kwargs)
        return call
    for name in _HOST:
        monkeypatch.setattr(torch.Tensor, name, guard(name, getattr(torch.Tensor, name)))
    nonzero = torch.nonzero

    def torch_nonzero(*args, **kwargs):
        if state["in_run"]:
            raise AssertionError("torch.nonzero inside pass 2's batch")
        return nonzero(*args, **kwargs)
    monkeypatch.setattr(torch, "nonzero", torch_nonzero)
    run, add, syncs = (psk_sync._Pass2._run, psk_sync._Pass2.add_block,
                       psk_sync._Pass2.syncs)

    def in_run(self, *args, **kwargs):
        state["in_run"] = True
        try:
            return run(self, *args, **kwargs)
        finally:
            state["in_run"] = False

    def in_block(self, *args, **kwargs):
        state["in_block"] = True
        state["per_block"].append(0)
        try:
            return add(self, *args, **kwargs)
        finally:
            state["in_block"] = False

    def counted(self):
        state["syncs"] += 1
        return syncs(self)
    monkeypatch.setattr(psk_sync._Pass2, "_run", in_run)
    monkeypatch.setattr(psk_sync._Pass2, "add_block", in_block)
    monkeypatch.setattr(psk_sync._Pass2, "syncs", counted)
    return state


def _meteor_capture():
    with open(os.path.join(ROOT, "benchmarks", "configs", "meteor_qpsk.json")) as f:
        cfg = json.load(f)
    raw, starts = qsynth.pass_bytes(
        1.5, cfg["sample_rate"], cfg["symbol_rate"], cfg["sync_entries"], 0.05,
        cfg["frame_spacing_s"], cfg["amplitude"], cfg["rrc_rolloff"],
        cfg["rrc_span_symbols"] // 2, cfg["offset_hz"] + cfg["carrier_error_hz"],
        2.0, int(cfg["pll"]["minsync_thresh"]), "cpu", 2 ** 31 + 17)
    return MeteorM2Decoder, raw, 4000, starts


def _funcube_capture():
    raw, starts = cs.synth_funcube_bytes(11.0, "cpu", seed=5)
    return FuncubeDecoder, raw, cs.FC_OFFSET_HZ, starts


@pytest.mark.parametrize("capture", [_funcube_capture, _meteor_capture],
                         ids=["funcube", "meteor"])
def test_block_loop_batches_without_host_copies(capture, host_guard):
    """No host copy or synchronise inside a batch, the same few calls a
    block outside it whatever the block's windows, one copy of the syncs a
    decode; one batch a block at most, every frame correlated once."""
    cls, raw, offset, starts = capture()
    dec = cls(DeviceRawSource(raw, cs.FS), offset, block_size=1_000_000,
              device="cpu")
    syncs = dec.get_syncs()
    blocks = -(-raw.shape[0] // 2 // 1_000_000)
    c = dec.counters
    assert dec.useful == 1 and len(syncs) == len(starts) - 1
    assert len(host_guard["per_block"]) == blocks
    # A indices and minsync flags: .cpu() and .numpy() each, whatever the
    # block's windows
    assert set(host_guard["per_block"]) == {4}
    assert host_guard["syncs"] == 1
    assert c["psk.pass2.correlations"] == len(starts)
    assert 1 <= c["psk.pass2.batches"] <= min(blocks, len(starts))
    assert c["psk.pass2.windows"] >= c["psk.pass2.correlations"]
