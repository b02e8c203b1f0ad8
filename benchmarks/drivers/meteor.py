"""Driver of the `meteor_qpsk` configuration: Meteor-M2 LRPT passes
decoded whole from bytes held on the card.

Each decode is a fresh `MeteorM2Decoder(...).get_syncs()` over a
`DeviceRawSource`, marked as a `meteor.get_syncs` range for the trace: a
2-minute piece (245.76 M samples, above the whole-capture path's 128 M)
goes through the block loop (13 blocks: the front end, K3 with the scan
state carried, host pass 2). The record keeps the program's counters
(`dec.counters`) beside its stage seconds.

For the one decode the harness samples, the driver keeps one block of the
scan, drawn from the seed, with `drivers/funcube.py`'s recorder around the
scan's public entry `ops.pll.symbol_scan`; the program's work is not
changed.

The check (`benchmarks/reference/qpsk.py` the reference), each number
with value <= limit passing:

- `baseband_gap`: the sampled block's filtered samples against the
  reference's, the 99.9th percentile of the gap over the reference's RMS;
- `symbol_gap`: the share of the block's symbols, from the first minsync
  event the two scans share on, whose A index lies more than a sample
  from the other scan's nearest, or whose minsync flag or needle choice
  differs from that symbol's (the larger of the program's and the
  reference's shares), the reference scanning from the port's state at
  the block's start;
- `sync_gap`: the largest distance, in samples, between a decoded sync and
  the reference sync of the planted frame it lies nearest, every decode;
- `extra_syncs`: decoded syncs that lie farther than `NEAR` from every
  planted frame's reference sync, or second on one frame, every decode;
- `frames_missed`: the share of planted frames with no decoded sync
  within `sync_gap`'s limit, every decode.

The sync numbers leave out the capture's first `LOCK_IN` samples (0.51 s,
the first 5 frames), where the loops lock from the initial state, and
`symbol_gap` leaves them out of the capture's first block.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from benchmarks.drivers.funcube import _ScanRecorder, baseband_gap
from benchmarks.harness import finite_or
from benchmarks.reference import qpsk as ref
from benchmarks.reference.apt import Precision
from benchmarks.synth import qpsk as synth

NUMBERS = ("baseband_gap", "symbol_gap", "sync_gap", "extra_syncs", "frames_missed")
# samples (10 ms): a decoded sync this near a frame's reference sync is
# that frame's, else extra
NEAR = 20_480
# samples (0.51 s) at the capture's start that the check leaves out: the
# loops lock there from the initial state (the AGC's mean settles over
# 65,536 events, two a symbol, ~0.46 s), the float32 and float64 timings
# part by more than a sample at times for up to ~0.2 s, and a minsync may
# fire on the unlocked loops' bits (`sync_numbers`)
LOCK_IN = 1 << 20


def setup(cfg, traffic, seed, device, workdir):
    fs = int(cfg["sample_rate"])
    raw, starts = synth.pass_bytes(
        float(traffic["seconds"]), fs, int(cfg["symbol_rate"]), cfg["sync_entries"],
        float(traffic["first_frame_s"]), float(cfg["frame_spacing_s"]),
        float(cfg["amplitude"]), float(cfg["rrc_rolloff"]),
        int(cfg["rrc_span_symbols"]) // 2, int(cfg["offset_hz"]) + int(cfg["carrier_error_hz"]), float(traffic["noise"]),
        int(cfg["pll"]["minsync_thresh"]), device, seed)
    n = raw.shape[0] // 2
    blocks = -(-n // int(cfg["block_samples"]))
    rng = np.random.default_rng([seed, 0xB10C])
    return {"cfg": cfg, "traffic": traffic, "device": device, "raw": raw,
            "starts": starts, "n": n, "block": int(rng.integers(0, blocks))}


def decode_once(st, sample):
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
    from directdemod_tpu_torch.ops import pll
    cfg = st["cfg"]
    pll.LAUNCHES = 0
    scan = pll.symbol_scan
    if sample:
        pll.symbol_scan = _ScanRecorder(scan, st["block"])
    try:
        dec = MeteorM2Decoder(DeviceRawSource(st["raw"], int(cfg["sample_rate"])),
                              cfg["offset_hz"], device=st["device"])
        with torch.profiler.record_function("meteor.get_syncs"):
            syncs = dec.get_syncs()
        if st["device"].type == "cuda":
            torch.cuda.synchronize()
    finally:
        rec, pll.symbol_scan = pll.symbol_scan, scan
    out = {"syncs": list(syncs), "useful": dec.useful,
           "stage_seconds": dec.stage_seconds, "launches": {"K3": pll.LAUNCHES},
           "counters": dict(getattr(dec, "counters", {}))}
    if sample:
        out["heavy"] = rec.kept
    return out


def capture_seconds(st):
    return st["n"] / float(st["cfg"]["sample_rate"])


def release(st):
    """The program's objects are the records' products only; nothing else
    to drop."""


def _unmatched(a, m, c, b, bm, bc) -> int:
    """How many symbols of `a` (A indices, minsync flags `m`, choices `c`)
    have no symbol of `b` within one sample of their A index (the nearest
    one taken) with the same minsync flag and needle choice."""
    if len(b) == 0:
        return len(a)
    pos = np.searchsorted(b, a)
    lo, hi = np.clip(pos - 1, 0, len(b) - 1), np.clip(pos, 0, len(b) - 1)
    k = np.where(np.abs(b[lo] - a) <= np.abs(b[hi] - a), lo, hi)
    bad = (np.abs(b[k] - a) > 1) | (m != bm[k]) | (c != bc[k])
    return int(np.count_nonzero(bad))


def symbol_gap(prog, want, lock_in: int = 0) -> float:
    """Share of symbols, from the first minsync event that the two scans
    place within a sample of each other at or after sample `lock_in` on,
    whose A-sample index lies more
    than one sample from the other scan's nearest, or whose minsync flag or
    needle choice differs from that symbol's: the larger of the program's
    share against the reference and the reference's against the program.
    `prog` and `want` are (A indices, minsync flags, choices), compared up
    to the earlier of their last A samples (both stop at the same step
    budget, so a scan that stepped shorter ends earlier). Scans that share
    no such event read 1. The symbols before that event are left out, as
    ROADMAP D15 compares Meteor's scans at the event level."""
    scans = [tuple(np.asarray(v, np.int64) for v in s) for s in (prog, want)]
    ev_p, ev_w = (a[m.astype(bool)] for a, m, _ in scans)
    ev_p, ev_w = ev_p[ev_p >= lock_in], ev_w[ev_w >= lock_in]
    pairs = np.argwhere(np.abs(ev_p[:, None] - ev_w[None, :]) <= 1)
    if not len(pairs):
        return 1.0
    first = min(ev_p[pairs[0, 0]], ev_w[pairs[0, 1]])
    last = min(s[0][-1] for s in scans)
    p, w = (tuple(v[(s[0] >= first) & (s[0] <= last + 1)] for v in s)
            for s in scans)
    return max(_unmatched(*p, *w) / len(p[0]), _unmatched(*w, *p) / len(w[0]))


def sync_numbers(prog, want, limit: float) -> dict:
    """`sync_gap`, `extra_syncs` and `frames_missed` of decoded syncs
    `prog` against the reference syncs `want` of every planted frame. The
    capture's first `LOCK_IN` samples are left out: the frames whose
    reference sync lies there, and the decoded syncs there or nearest such
    a frame. While the loops lock from the initial state the scan's bits
    are not yet the signal's, and a minsync may fire on them, as upstream
    (on one seed an event 0.15 s in, 670 symbols before its frame's sync,
    shut the gate on the frame and gave a sync 13,951 samples early); the
    first frame, which the decoder never reports, lies there too."""
    want = np.asarray(want, np.float64)
    gap, extra, hit = 0.0, 0, np.zeros(len(want), bool)
    taken = set()
    for s in np.asarray(prog, np.float64):
        j = int(np.argmin(np.abs(want - s)))
        d = abs(want[j] - s)
        if s < LOCK_IN or want[j] < LOCK_IN:
            continue
        if d > NEAR or j in taken:
            extra += 1
            continue
        taken.add(j)
        gap = max(gap, d)
        hit[j] |= d <= limit
    held = want >= LOCK_IN
    missed = np.count_nonzero(~hit[held]) / max(np.count_nonzero(held), 1)
    return {"sync_gap": float(gap), "extra_syncs": float(extra),
            "frames_missed": float(missed)}


def _kept_block(st, kept, precision="fp64"):
    """The reference's filtered samples of a kept scan call's block at
    `precision`, and the port's scan state before it."""
    cfg, a = st["cfg"], kept["start"]
    x = ref.filtered(st["raw"], cfg, a, a + int(kept["x"].shape[0]),
                     ref.lowpass_response(cfg), Precision(precision))
    f, i = (kept["state"][k][0].cpu().tolist() for k in ("f", "i"))
    return x, ref.ScanState(f, i)


def _lock_in(kept) -> int:
    return LOCK_IN if kept["start"] == 0 else 0


def _ref_scan(x, state, cfg, precision="fp64"):
    return ref.scan(x.to(torch.complex128).cpu().numpy(), state, cfg, precision)


def block_numbers(st, kept) -> dict:
    """baseband_gap and symbol_gap of one kept scan call against the
    reference, which scans from the port's state at the block's start."""
    want, state = _kept_block(st, kept)
    syms = kept["syms"]
    prog = (syms.a_idx.cpu().tolist(), syms.minsync.cpu().tolist(),
            syms.chosen.cpu().tolist())
    return {"baseband_gap": baseband_gap(kept["x"], want),
            "symbol_gap": symbol_gap(prog, _ref_scan(want, state, st["cfg"]),
                                     _lock_in(kept))}


def reference_syncs(st, precision="fp64") -> list:
    key = "want_" + precision
    if key not in st:
        st[key] = ref.frame_syncs(st["raw"], st["cfg"], st["starts"],
                                  Precision(precision))
    return st[key]


def control(st) -> dict:
    """The control's numbers, each layer's reference one precision lower in
    the program's place, against the reference: the front end at TF32
    over the kept block (`baseband_gap`); the scan's loop in bfloat16 over
    the float64 front end's block (`symbol_gap`), from the initial state,
    which is the state a bfloat16 scan carries into every block: its AGC's
    mean never leaves the initial 3.0, as 3.0 * 65535 + |v| rounds back to
    3.0 * 65535 in bfloat16 for any |v| under 512; and the frames' syncs at
    TF32 (the control's syncs as if decoded: every frame but the first)."""
    cfg, kept = st["cfg"], st["last_kept"]
    want, state = _kept_block(st, kept)
    tf32, _ = _kept_block(st, kept, "tf32")
    bf16 = _ref_scan(want, ref.initial_state(cfg), cfg, "tf32")
    nums = {"baseband_gap": baseband_gap(tf32, want),
            "symbol_gap": symbol_gap(bf16, _ref_scan(want, state, cfg),
                                     _lock_in(kept))}
    nums.update(sync_numbers(reference_syncs(st, "tf32")[1:], reference_syncs(st),
                             cfg["limits"]["sync_gap"]))
    return nums


def planted(st) -> dict:
    """Readings of a fault planted in the reference put in the program's
    place: every frame's sync one symbol late."""
    cfg = st["cfg"]
    late = np.asarray(reference_syncs(st)[1:]) + cfg["sample_rate"] / cfg["symbol_rate"]
    nums = sync_numbers(late, reference_syncs(st), cfg["limits"]["sync_gap"])
    return {f"{k}.one_symbol_late": v for k, v in nums.items()}


def check(st, records):
    lim = st["cfg"]["limits"]
    want = reference_syncs(st)
    worst = {k: 0.0 for k in ("sync_gap", "extra_syncs", "frames_missed")}
    block = None
    failed = 0
    for r in records:
        nums = sync_numbers(r["syncs"], want, lim["sync_gap"])
        bad = r["useful"] != 1 or any(nums[k] > lim[k] for k in nums)
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
        if "heavy" in r:
            if r["heavy"] is None:
                print("the decode never called ops.pll.symbol_scan: "
                      "no block of the scan to check", file=sys.stderr)
                block = {}
                bad = True
            else:
                st["last_kept"] = r["heavy"]
                block = block_numbers(st, r["heavy"])
                bad = bad or any(block[k] > lim[k] for k in block)
        failed += int(bad)
    counts: dict = {}
    for r in records:
        for k, v in r.get("counters", {}).items():
            counts[k] = counts.get(k, 0) + v
    print("program counters a decode: " + ", ".join(
        f"{k} {v / len(records)}" for k, v in sorted(counts.items()))
        if records else "no decodes", flush=True)
    vals = {**worst, **{k: (block or {}).get(k) for k in ("baseband_gap", "symbol_gap")}}
    return [(k, finite_or(vals[k] if vals[k] is not None else float("inf"), 1e9),
             lim[k]) for k in NUMBERS], failed
