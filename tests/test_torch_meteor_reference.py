"""The port's Meteor-M2 decode held to the benchmark's plain QPSK reference
(`benchmarks/reference/qpsk.py`) on a seeded 3-s capture of
`benchmarks/synth/qpsk.py`, on the CPU: through the block loop (blocks of
1,000,000 samples, the scan state carried across them, as the 2-minute
cell runs on the card) and as one block (the plan of captures of at most
`psk_sync._CAPTURE_SEG_MAX` samples). The scan of one
block, from the port's own state at its start, against the reference's;
every decoded sync against its planted frame's reference sync; and the
decoder's counters of the scan's step budget and of pass 2's windows."""
import json
import os

import numpy as np
import pytest
import torch

from benchmarks.reference import qpsk as ref
from benchmarks.reference.apt import Precision
from benchmarks.synth import qpsk as synth
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
from directdemod_tpu_torch.ops import pll

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 16
SECONDS = 3.0


def _cfg(block: int) -> dict:
    with open(os.path.join(ROOT, "benchmarks", "configs", "meteor_qpsk.json")) as f:
        cfg = json.load(f)
    cfg["block_samples"] = block     # the oscillator restarts every block
    return cfg


@pytest.fixture(scope="module")
def capture():
    cfg = _cfg(20_000_000)
    raw, starts = synth.pass_bytes(
        SECONDS, cfg["sample_rate"], cfg["symbol_rate"], cfg["sync_entries"], 0.05,
        cfg["frame_spacing_s"], cfg["amplitude"], cfg["rrc_rolloff"],
        cfg["rrc_span_symbols"] // 2, cfg["offset_hz"] + cfg["carrier_error_hz"], 2.0,
        int(cfg["pll"]["minsync_thresh"]), "cpu", SEED)
    return raw, starts


def _decode(raw, block_size, monkeypatch):
    """The decode, every scan call's input, state before and symbols kept."""
    calls = []
    orig = pll.symbol_scan

    def keep(p, x, state, sync, sync1):
        before = {k: v.clone() for k, v in state.items()}
        new, syms = orig(p, x, state, sync, sync1)
        calls.append((x, before, syms))
        return new, syms
    monkeypatch.setattr(pll, "symbol_scan", keep)
    dec = MeteorM2Decoder(DeviceRawSource(raw, 2048000), 4000,
                          block_size=block_size, device="cpu")
    return dec, dec.get_syncs(), calls


def _unmatched_from(a, first, b):
    """How many symbols of `a` from sample `first` on, inside the span `b`
    covers, have no symbol of `b` within one sample."""
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    a = a[(a >= first) & (a <= b[-1])]
    pos = np.clip(np.searchsorted(b, a), 1, len(b) - 1)
    near = np.minimum(np.abs(b[pos] - a), np.abs(b[pos - 1] - a))
    return int(np.count_nonzero(near > 1))


# (block size, the scan call compared, budget stops at least, minsync
# events skipped): the whole capture's scan starts from the initial state,
# and its first event falls while the loops lock, where float32 and
# float64 trajectories part by a few samples (the tests compare from the
# second sync on there, as the port's other Meteor tests do)
@pytest.mark.parametrize("block_size, call, budget_stops, skip",
                         [(1_000_000, 1, 6, 0), (None, 0, 1, 1)],
                         ids=["block_loop", "whole_capture"])
def test_meteor_decode_holds_to_the_plain_reference(capture, monkeypatch, block_size,
                                                    call, budget_stops, skip):
    raw, starts = capture
    cfg = _cfg(block_size or 20_000_000)
    dec, syncs, calls = _decode(raw, block_size, monkeypatch)
    assert len(calls) == (7 if block_size else 1)
    assert dec.useful == 1

    # one block's scan from the port's state at its start
    x, before, syms = calls[call]
    a0 = sum(int(c[0].shape[0]) for c in calls[:call])
    h = ref.lowpass_response(cfg)
    want_x = ref.filtered(raw, cfg, a0, a0 + int(x.shape[0]), h, Precision("fp64"))
    rel = float((x.to(torch.complex128) - want_x).abs().max()
                / want_x.abs().pow(2).mean().sqrt())
    assert rel < 2e-5
    st = ref.ScanState(before["f"][0].tolist(), before["i"][0].tolist())
    ra, rm, rc = ref.scan(want_x.numpy(), st, cfg)
    pa, pm, pc = (syms.a_idx.numpy(), syms.minsync.numpy(),
                  syms.chosen.numpy().astype(np.int64))
    ev_p = pa[pm][skip:]
    ev_r = np.asarray(ra)[np.asarray(rm)][skip:]
    assert len(ev_p) == len(ev_r) >= 4
    assert np.all(np.abs(ev_p - ev_r) <= 1), (ev_p, ev_r)
    assert np.all(pc[pm][skip:] == np.asarray(rc)[np.asarray(rm)][skip:])
    # A indices within a sample from the first event compared on (before
    # it, from the initial state, the loops lock and the two scans settle
    # a few symbols apart on the same sampling points), but for a rare
    # symbol where the float32 and float64 timing part for one step (ROADMAP
    # D15: such steps move an index, never an event)
    first = max(ev_p[0], ev_r[0])
    assert _unmatched_from(pa, first, ra) <= 1e-4 * len(pa)
    assert _unmatched_from(ra, first, pa) <= 1e-4 * len(ra)

    # every decoded sync within the cell's limit of its planted frame's
    # reference sync, every frame after the first but the last block's
    # (the step budget leaves its end unscanned) decoded
    want = np.asarray(ref.frame_syncs(raw, cfg, starts, Precision("fp64")))
    got = np.asarray(syncs)
    nearest = want[np.argmin(np.abs(got[:, None] - want[None, :]), axis=1)]
    assert np.all(np.abs(got - nearest) <= cfg["limits"]["sync_gap"])
    assert len(set(nearest.tolist())) == len(got) >= len(starts) - 2

    c = dec.counters
    assert c["psk.symbol_scan.symbols"] == sum(s.count for _, _, s in calls)
    assert c["psk.symbol_scan.budget_stops"] >= budget_stops
    assert 0 < c["psk.symbol_scan.samples_left"] < 0.1 * raw.shape[0] // 2
    assert c["psk.pass2.windows"] >= c["psk.pass2.correlations"] == len(got) + 1


def test_budget_counters_follow_the_scan(capture):
    """A scan the budget cuts short counts one stop and the samples after
    its last A index, from the scan's own flag; a scan that reaches the
    block's end counts none. The capture's first 100,000 samples, scanned
    from the initial state, stop short: the timing steps short while the
    loops lock. Silence steps a whole symbol each time and reaches the end."""
    raw, _ = capture
    cfg = _cfg(20_000_000)
    dec = MeteorM2Decoder(DeviceRawSource(raw, 2048000), 4000, device="cpu")
    n = 100_000
    x = ref.filtered(raw, cfg, 0, n, ref.lowpass_response(cfg),
                     Precision("fp64")).to(torch.complex64)
    _, syms = dec._scan_seq(x, pll.initial_state(dec.p, 120, 1, "cpu"))
    assert pll.LAST_TRUNCATED and syms.count == pll.max_symbols(dec.p, n)
    dec._count_scan(syms, n)
    left = n - 1 - int(syms.a_idx[-1])
    assert left > 0
    assert dec.counters == {"psk.symbol_scan.symbols": syms.count,
                            "psk.symbol_scan.budget_stops": 1,
                            "psk.symbol_scan.samples_left": left}
    _, quiet = dec._scan_seq(torch.zeros(n, dtype=torch.complex64),
                             pll.initial_state(dec.p, 120, 1, "cpu"))
    assert not pll.LAST_TRUNCATED
    dec._count_scan(quiet, n)
    assert dec.counters["psk.symbol_scan.budget_stops"] == 1
    assert dec.counters["psk.symbol_scan.symbols"] == syms.count + quiet.count
