"""The `meteor_qpsk` configuration's parts on the CPU at tiny sizes: the
QPSK synthesizer, the plain reference against the synthesizer's ground
truth, the correctness comparison of `drivers/meteor.py` against a planted
fault and the precision control, the per-layer readers on a trace from a program
that lacks their counters, and the cell run whole through the harness."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, make_root, run_cell

from benchmarks.harness import load_module, resolve
from benchmarks.reference import qpsk as ref
from benchmarks.reference.apt import Precision
from benchmarks.synth import qpsk as synth

SEED = 2 ** 31 + 61


def _cfg():
    with open(os.path.join(BENCH, "configs", "meteor_qpsk.json")) as f:
        return json.load(f)


def _driver():
    return load_module(os.path.join(BENCH, "drivers", "meteor.py"), "drv_meteor")


@pytest.fixture(scope="module")
def qpsk_pass():
    torch.set_num_threads(2)
    cfg = _cfg()
    raw, starts = synth.pass_bytes(
        1.5, cfg["sample_rate"], cfg["symbol_rate"], cfg["sync_entries"], 0.05,
        cfg["frame_spacing_s"], cfg["amplitude"], cfg["rrc_rolloff"],
        cfg["rrc_span_symbols"] // 2, cfg["offset_hz"] + cfg["carrier_error_hz"], 2.0,
        int(cfg["pll"]["minsync_thresh"]), "cpu", SEED)
    return cfg, raw, starts


def test_cell_resolves_by_name():
    spec = resolve(ROOT, "meteor_pass_2min")
    assert spec["cfg"]["name"] == "meteor_qpsk" and spec["cell"]["chips"] == 1
    assert os.path.basename(spec["driver"]) == "meteor.py"
    names = [m["name"] for m in spec["per_layer"]]
    assert {"meteor.symbol_scan_s", "meteor.pass2_s", "meteor.pass2_windows",
            "meteor.k3_ns_symbol", "device.idle_pct"} <= set(names)
    assert not any(n.startswith(("noaa.", "psk.", "k1_", "k3_")) for n in names)
    assert spec["traffic"]["seconds"] * spec["cfg"]["sample_rate"] == 245_760_000


def test_synth_plants_the_frames(qpsk_pass):
    cfg, raw, starts = qpsk_pass
    assert raw.dtype == torch.uint8 and raw.shape[0] == 2 * int(1.5 * cfg["sample_rate"])
    assert len(starts) == 13
    assert np.all(np.diff(starts) == pytest.approx(0.11 * cfg["sample_rate"], abs=1))
    # the pulse: 1 at its centre, zero at the other symbols' centres
    # (Nyquist for the raised cosine only; the root's tails are small)
    g = synth.rrc(np.arange(-8, 9).astype(float), cfg["rrc_rolloff"], 8)
    assert g[8] == 1.0 and np.max(np.abs(np.delete(g, 8))) < 0.1


def test_filler_clearing_leaves_no_near_sync():
    cfg = _cfg()
    rng = np.random.default_rng(5)
    sync = np.asarray(cfg["sync_entries"])
    n = 20_000
    bi, bq = rng.integers(0, 2, n), rng.integers(0, 2, n)
    # plant near-copies of both variants in the filler: 20 entries off
    s0, s1 = synth.sync_variants(sync)
    for w, pat, rails in ((1000, s0, (bi, bq)), (9000, s1, (bq, bi)),
                          (15000, 1 - s0, (bi, bq))):
        near = pat.copy()
        near[rng.choice(len(pat), 20, replace=False)] ^= 1
        rails[0][w:w + 60], rails[1][w:w + 60] = near[0::2], near[1::2]
    keep = np.zeros(n, bool)
    synth.clear_false_syncs(bi, bq, sync, keep, 30, rng, "cpu")
    for rails, pat in (((bi, bq), s0), ((bq, bi), s1)):
        e = np.stack(rails, 1).reshape(-1)
        win = np.lib.stride_tricks.sliding_window_view(e, len(pat))[0::2]
        d = np.count_nonzero(win != pat, axis=1)
        assert np.all((d > 30) & (d < len(pat) - 30))


def test_reference_finds_the_planted_frames(qpsk_pass):
    """The needle's 'same' centre behind the low-pass: ~858 samples after
    each frame's first sample, on every frame."""
    cfg, raw, starts = qpsk_pass
    got = np.asarray(ref.frame_syncs(raw, cfg, starts, Precision("fp64")))
    assert np.all(np.abs(got - starts - 858) <= 3), got - starts
    assert ref.carrier_hz(raw, cfg, Precision("fp64")) == pytest.approx(100.0, abs=0.5)


def test_reference_scan_from_the_start(qpsk_pass):
    """The scan from the decoder's initial state over the reference's own
    filtered capture fires its minsync inside every planted frame after
    the loops lock and nowhere else, the needle choice 0 or 2."""
    cfg, raw, starts = qpsk_pass
    n = raw.shape[0] // 2
    x = ref.filtered(raw, cfg, 0, n, ref.lowpass_response(cfg), Precision("fp64"))
    a, m, c = ref.scan(x.numpy(), ref.initial_state(cfg), cfg)
    T = cfg["sample_rate"] / cfg["symbol_rate"]
    assert n / T - 100 < len(a) <= int(n / T) + 3 + int(n * 4e-6 / T)
    fired = np.asarray(a)[np.asarray(m)]
    span = 60 * T
    inside = [(fired > s) & (fired < s + span + 1000) for s in starts]
    assert np.all(np.any(inside, axis=0))
    assert all(np.any(w) for w in inside[1:])
    assert set(np.asarray(c)[np.asarray(m)].tolist()) <= {0, 2}


def test_sync_one_symbol_late_fails(qpsk_pass):
    cfg, raw, starts = qpsk_pass
    drv = _driver()
    st = {"cfg": cfg, "raw": raw, "starts": starts}
    lim = cfg["limits"]
    want = drv.reference_syncs(st)
    ok = drv.sync_numbers(want[1:], want, lim["sync_gap"])
    assert ok == {"sync_gap": 0.0, "extra_syncs": 0.0, "frames_missed": 0.0}
    late = drv.planted(st)
    assert late["sync_gap.one_symbol_late"] > lim["sync_gap"]
    assert late["frames_missed.one_symbol_late"] > lim["frames_missed"]
    # a sync far from every frame, and a second sync on one frame, are extra
    far = drv.sync_numbers(list(want[1:]) + [want[8] + 50_000, want[10] + 2], want,
                           lim["sync_gap"])
    assert far["extra_syncs"] == 2 > lim["extra_syncs"]
    # in the lock-in stretch neither counts, nor a sync off its frame, nor
    # a frame with no sync; after it a sync off its frame does
    assert want[4] < drv.LOCK_IN <= want[5]
    early = drv.sync_numbers([want[2] - 13_951, want[3] + 50_000] + list(want[5:]),
                             want, lim["sync_gap"])
    assert early == ok
    off = drv.sync_numbers([want[6] - 13_951] + list(want[5:6]) + list(want[7:]),
                           want, lim["sync_gap"])
    assert off["sync_gap"] == 13_951 > lim["sync_gap"]
    assert off["frames_missed"] == pytest.approx(1 / 8)


def _toy_scan(shift=(), events=(100, 400, 700), n=1000):
    """(A indices, minsync flags, choices) of a toy scan: a symbol every
    28 samples, minsync events at the given symbols, the A indices of the
    symbols in `shift` (index, samples) moved."""
    a = np.arange(n, dtype=np.int64) * 28
    for k, d in shift:
        a[k] += d
    m = np.zeros(n, bool)
    m[list(events)] = True
    return a, m, np.zeros(n, np.int64)


@pytest.mark.parametrize("prog, lock_in, want", [
    (_toy_scan(), 0, 0.0),
    # before the first shared event: left out
    (_toy_scan([(k, 5) for k in range(50)]), 0, 0.0),
    # ten symbols two samples off after it, of the 900 from it on
    (_toy_scan([(k, 2) for k in range(500, 510)]), 0, 10 / 900),
    (_toy_scan([(k, 1) for k in range(500, 510)]), 0, 0.0),
    # an event of one scan alone: its symbol differs
    (_toy_scan(events=(100, 400, 700, 800)), 0, 1 / 900),
    # no event shared
    (_toy_scan([(100, 3), (400, 3), (700, 3)]), 0, 1.0),
    (_toy_scan(events=()), 0, 1.0),
    # after lock_in only: the first shared event is the third
    (_toy_scan([(k, 2) for k in range(200, 300)]), 400 * 28, 0.0),
    (_toy_scan([(k, 2) for k in range(200, 300)]), 0, 100 / 900),
    # the reference runs on past the program's last symbol: not compared
    (_toy_scan(n=980), 0, 0.0),
], ids=["same", "before_event", "two_off", "one_off", "lone_event", "no_shared",
        "no_events", "lock_in", "no_lock_in", "ends"])
def test_symbol_gap_compares_from_the_first_shared_event(prog, lock_in, want):
    assert _driver().symbol_gap(prog, _toy_scan(), lock_in) == pytest.approx(want)


def test_control_fails_at_least_one_number(qpsk_pass):
    """The reference at TF32 / bfloat16 in the program's place fails the
    check: the block's baseband (the front end at TF32) and its symbols
    (the scan in bfloat16, whose AGC never leaves its initial mean, finds
    no minsync event)."""
    cfg, raw, starts = qpsk_pass
    drv = _driver()
    n = 1_000_000
    f, i = ref.initial_rows(cfg)
    st = {"cfg": cfg, "raw": raw, "starts": starts,
          "last_kept": {"start": 0, "x": torch.zeros(n, dtype=torch.complex64),
                        "state": {"f": torch.tensor([f]), "i": torch.tensor([i])}}}
    nums = drv.control(st)
    lim = cfg["limits"]
    assert nums["baseband_gap"] > lim["baseband_gap"]
    assert nums["symbol_gap"] > lim["symbol_gap"]
    assert any(nums[k] > lim[k] for k in nums), nums


@pytest.mark.parametrize("name", ["meteor.symbol_scan_s", "meteor.pass2_s",
                                  "meteor.pass2_windows", "meteor.k3_ns_symbol"])
def test_readers_read_nothing_without_the_program_counters(name, monkeypatch):
    """With a program that counts neither the scan's symbols nor pass 2's
    windows, the readers of those counts return None and do not raise."""
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "session_counts", lambda: {"psk.pass2.correlations": 3})
    from benchmarks.trace import Events
    ev = Events({"traceEvents": [
        {"ph": "X", "ts": 0, "dur": 100, "cat": "user_annotation", "name": "bench.decode"},
        {"ph": "X", "ts": 10, "dur": 50, "cat": "kernel", "name": "symbol_scan_kernel"}]})
    reader = load_module(os.path.join(BENCH, "layers", f"{name}.py"), "r_" + name)
    assert reader.read({"records": [{"stage_seconds": {}}], "events": ev}) is None
    assert reader.read({"records": [], "events": None}) is None


def test_k3_reader_divides_kernel_time_by_symbols(monkeypatch):
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "session_counts",
                        lambda: {"psk.symbol_scan.symbols": 100_000})
    from benchmarks.trace import Events
    ev = Events({"traceEvents": [
        {"ph": "X", "ts": 0, "dur": 1e6, "cat": "user_annotation", "name": "bench.decode"},
        {"ph": "X", "ts": 10, "dur": 30_000, "cat": "kernel", "name": "symbol_scan_kernel"},
        {"ph": "X", "ts": 50_000, "dur": 28_000, "cat": "kernel", "name": "symbol_scan_kernel"}]})
    reader = load_module(os.path.join(BENCH, "layers", "meteor.k3_ns_symbol.py"), "r_k3")
    assert reader.read({"records": [{}], "events": ev}) == pytest.approx(580.0)


def _meteor_root(tmp_path, seconds=3.0, block=2_500_000, monkeypatch=None):
    """The cell at `seconds` through the decoder's block loop (blocks of
    `block` samples), the configuration's block size set to match. Each
    block's scan stops at the step budget ~50,000 samples before its end
    and the next starts there (`PERF.md`); at this size and seed no planted
    sync lies in such a tail, so every frame after the first comes back,
    where the 2-minute cell forgives the few that do."""
    from directdemod_tpu_torch.models import meteorm2, psk_sync
    monkeypatch.setattr(meteorm2, "PROC_CHUNKSIZE", block)
    monkeypatch.setattr(psk_sync, "_CAPTURE_SEG_MAX", 0)
    root = make_root(tmp_path)
    b = os.path.join(root, "benchmarks")
    for sub, name, change in (("configs", "meteor_qpsk", {"block_samples": block}),
                              ("workloads", "meteor_pass_2min", {"seconds": seconds})):
        path = os.path.join(b, sub, f"{name}.json")
        with open(path) as f:
            d = json.load(f)
        d.update(change)
        os.remove(path)
        with open(path, "w") as f:
            json.dump(d, f)
    return root


def test_cell_runs_whole_and_correct(tmp_path, monkeypatch, capsys):
    root = _meteor_root(tmp_path, monkeypatch=monkeypatch)
    rc, res, err, out = run_cell(root, "meteor_pass_2min", SEED, 0.01, capsys, trace=True)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    m = res["metrics"]
    assert m["meteor.pass2_windows"]["value"] >= 26
    assert m["meteor.symbol_scan_s"]["value"] > 0 and m["meteor.pass2_s"]["value"] > 0
    assert "meteor.k3_ns_symbol" not in m          # no card, no kernel
    assert set(res["checks"]) == {"baseband_gap", "symbol_gap", "sync_gap",
                                  "extra_syncs", "frames_missed"}
    assert "psk.symbol_scan.budget_stops" in out


def test_cell_catches_a_sync_altered(tmp_path, monkeypatch, capsys):
    root = _meteor_root(tmp_path, monkeypatch=monkeypatch)
    from directdemod_tpu_torch.models.psk_sync import PskSyncDetector
    orig = PskSyncDetector.get_syncs
    monkeypatch.setattr(PskSyncDetector, "get_syncs",
                        lambda self: [s + 29.0 for s in orig(self)])
    rc, res, err, _ = run_cell(root, "meteor_pass_2min", SEED, 0.01, capsys)
    assert rc == 0 and res["correct"] is False, err[-2000:]
    assert res["checks"]["sync_gap"]["value"] > res["checks"]["sync_gap"]["limit"]
