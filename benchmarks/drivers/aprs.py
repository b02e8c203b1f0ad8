"""Driver of the `aprs_afsk1200` configuration: an ISS APRS pass decoded
whole from bytes held on the card.

Each decode is a fresh `Afsk1200Decoder(...).get_frames()` over a
`DeviceRawSource`, marked as an `afsk.get_frames` range for the trace:
the decoder's one-block plan, one K1 launch over the whole capture and one
K2 launch over its whole audio. The record keeps the frames' fields, the
program's counters (`dec.counters`) and its stage seconds.

For the one decode the harness samples, the driver wraps the public entry
`ops.peaks.lookahead_events` and keeps that decode's own edge strength over
a window of `WINDOW` audio samples drawn from the seed, and its K2 events
(copied to the host after the call; the program's work is not changed).

The check (`benchmarks/reference/afsk.py` the reference), each number
with value <= limit passing:

- `edge_gap`: the window's edge strength against the reference's, the
  99.9th percentile of the gap over the reference's RMS;
- `peak_gap`: the share of the reference walk's positive peaks in the
  window, from its third event on, at whose position the program's walk
  puts no positive peak, plus the difference of the two counts there;
- `frames_missed`: the share of planted frames not decoded, in order,
  every decode;
- `extra_frames`: frames decoded that were not planted, or out of order,
  every decode;
- `ref_frames_gap`: the frames the reference decodes in the window against
  the program's frames among the planted frames wholly inside it, their
  symmetric difference; frames planted across the window's ends are left
  out on both sides.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from benchmarks.harness import finite_or
from benchmarks.reference import afsk as ref
from benchmarks.synth import afsk as synth

NUMBERS = ("edge_gap", "peak_gap", "frames_missed", "extra_frames", "ref_frames_gap")
WINDOW = 1 << 21          # audio samples (~94 s) the reference walks
EDGE_S = 0.25             # frames this near the window's ends are left out


def setup(cfg, traffic, seed, device, workdir):
    raw, frames = synth.pass_bytes(float(traffic["seconds"]), cfg, traffic, device,
                                   seed)
    M = ref.audio_length(raw, cfg)
    rng = np.random.default_rng([seed, 0xED6E])
    m0 = int(rng.integers(0, max(M - WINDOW, 0) + 1))
    return {"cfg": cfg, "device": device, "raw": raw, "frames": frames,
            "m0": m0, "m1": min(m0 + WINDOW, M)}


class _WalkRecorder:
    """Stands in for `ops.peaks.lookahead_events`: calls it, then keeps the
    edge strength over [m0, m1) and the events on the host."""

    def __init__(self, fn, m0: int, m1: int):
        self.fn, self.m0, self.m1 = fn, m0, m1
        self.kept = None

    def __call__(self, y, lookahead, *args, **kwargs):
        events = self.fn(y, lookahead, *args, **kwargs)
        self.kept = {"edge": y[self.m0:self.m1].double().cpu().numpy(),
                     "events": tuple(t.cpu().numpy() for t in events)}
        return events


def decode_once(st, sample):
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
    from directdemod_tpu_torch.ops import ddc, peaks
    cfg = st["cfg"]
    ddc.LAUNCHES = peaks.LAUNCHES = 0
    walk = peaks.lookahead_events
    if sample:
        peaks.lookahead_events = _WalkRecorder(walk, st["m0"], st["m1"])
    try:
        dec = Afsk1200Decoder(DeviceRawSource(st["raw"], int(cfg["sample_rate"])),
                              cfg["offset_hz"], bw=int(cfg["bw"]), device=st["device"])
        with torch.profiler.record_function("afsk.get_frames"):
            frames = dec.get_frames()
        if st["device"].type == "cuda":
            torch.cuda.synchronize()
    finally:
        rec, peaks.lookahead_events = peaks.lookahead_events, walk
    out = {"frames": [(f.destination, f.source, f.path, f.control, f.protocol, f.info)
                      for f in frames],
           "useful": dec.useful, "stage_seconds": dec.stage_seconds,
           "launches": {"K1": ddc.LAUNCHES, "K2": peaks.LAUNCHES},
           "counters": dict(getattr(dec, "counters", {}))}
    if sample:
        out["heavy"] = rec.kept
    return out


def capture_seconds(st):
    return st["raw"].shape[0] // 2 / float(st["cfg"]["sample_rate"])


def release(st):
    """The program's objects are the records' products only; nothing else
    to drop."""


def frame_numbers(got: list, planted: list) -> dict:
    """`frames_missed` and `extra_frames` of the decoded frames' fields
    `got` against the planted frames, in order: each decoded frame is
    matched to the first planted frame with its fields after the last one
    matched; one with none is extra."""
    want = [f.key() for f in planted]
    at, hit, extra = 0, 0, 0
    for g in got:
        j = next((k for k in range(at, len(want)) if want[k] == tuple(g)), None)
        if j is None:
            extra += 1
        else:
            hit += 1
            at = j + 1
    return {"frames_missed": (len(want) - hit) / max(len(want), 1),
            "extra_frames": float(extra)}


def edge_gap(prog: np.ndarray, want: np.ndarray) -> float:
    d = np.abs(np.asarray(prog, np.float64) - want)
    rms = float(np.sqrt(np.mean(want * want)))
    return float(np.percentile(d, 99.9)) / rms if rms > 0 else float("inf")


def peak_gap(prog_max: np.ndarray, ref_events: list) -> float:
    """Share of the reference's positive peaks from its third event on
    that the program's positive-peak positions `prog_max` miss, plus the
    difference of the counts over the same span."""
    want = np.asarray([p for _, p, _, k in ref_events[2:] if k], np.int64)
    if len(want) == 0:
        return float("inf")
    prog = np.asarray(prog_max, np.int64)
    prog = prog[(prog >= want[0]) & (prog <= want[-1])]
    missed = np.count_nonzero(~np.isin(want, prog))
    return (missed + abs(len(prog) - len(want))) / len(want)


def _window_keys(st) -> tuple[set, set]:
    """The planted frames wholly inside the window (`EDGE_S` from its ends),
    and those across its ends."""
    cfg = st["cfg"]
    j, rate = ref.rates(cfg)
    edge = int(EDGE_S * rate)
    lo, hi = st["m0"] + edge, st["m1"] - int(cfg["lookahead"]) - edge
    inside, across = set(), set()
    for f in st["frames"]:
        a, b = f.first_sample // j - 1, f.last_sample // j
        if a >= lo and b < hi:
            inside.add(f.key())
        elif b >= st["m0"] - edge and a < st["m1"] + edge:
            across.add(f.key())
    return inside, across


def window_numbers(st, edge: np.ndarray, prog_max: np.ndarray, prog_frames: list,
                   want: dict) -> dict:
    """edge_gap, peak_gap and ref_frames_gap of a window's edge strength,
    positive peaks and frames against the reference's `want`."""
    inside, across = _window_keys(st)
    ref_set = {tuple(f) for f in want["frames"]} - across
    prog_set = {tuple(f) for f in prog_frames} & inside
    return {"edge_gap": edge_gap(edge, want["edge"]),
            "peak_gap": peak_gap(prog_max, want["events"]),
            "ref_frames_gap": float(len(ref_set ^ prog_set))}


def reference(st, precision="fp64") -> dict:
    key = "want_" + precision
    if key not in st:
        st[key] = ref.decode(st["raw"], st["cfg"], st["m0"], st["m1"], precision)
    return st[key]


def _program_max(kept) -> np.ndarray:
    _, pos, _, is_max = kept["events"]
    return pos[is_max.astype(bool)]


def control(st) -> dict:
    """The control's numbers: the reference in TF32 over the window in the
    program's place (its edge strength, positive peaks and frames), against
    the reference."""
    low = reference(st, "tf32")
    return window_numbers(st, low["edge"], low["peaks"], low["frames"], reference(st))


def planted(st) -> dict:
    """Readings of faults planted in the reference put in the program's
    place: one info byte altered, one frame dropped, the positive peaks
    one baud late."""
    keys = [f.key() for f in st["frames"]]
    k = len(keys) // 2
    altered = list(keys)
    info = altered[k][5]
    altered[k] = altered[k][:5] + (info[:3] + chr(ord(info[3]) ^ 1) + info[4:],)
    want = reference(st)
    spb = int(st["cfg"]["bw"]) // int(st["cfg"]["baud"])
    out = {f"{n}.info_byte_altered": v
           for n, v in frame_numbers(altered, st["frames"]).items()}
    out.update({f"{n}.frame_dropped": v
                for n, v in frame_numbers(keys[:k] + keys[k + 1:], st["frames"]).items()})
    out["peak_gap.one_baud_late"] = peak_gap(want["peaks"] + spb, want["events"])
    return out


def check(st, records):
    lim = st["cfg"]["limits"]
    worst = {"frames_missed": 0.0, "extra_frames": 0.0}
    win = None
    failed = 0
    for r in records:
        nums = frame_numbers(r["frames"], st["frames"])
        bad = r["useful"] != 1 or any(nums[k] > lim[k] for k in nums)
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
        if "heavy" in r:
            if r["heavy"] is None:
                print("the decode never called ops.peaks.lookahead_events: "
                      "no walk to check", file=sys.stderr)
                win = {}
                bad = True
            else:
                win = window_numbers(st, r["heavy"]["edge"], _program_max(r["heavy"]),
                                     r["frames"], reference(st))
                bad = bad or any(win[k] > lim[k] for k in win)
        failed += int(bad)
    counts: dict = {}
    for r in records:
        for k, v in r.get("counters", {}).items():
            counts[k] = counts.get(k, 0) + v
    print(f"{len(st['frames'])} frames planted; program counters a decode: " + ", ".join(
        f"{k} {v / len(records)}" for k, v in sorted(counts.items()))
        if records else "no decodes", flush=True)
    vals = {**worst, **{k: (win or {}).get(k)
                        for k in ("edge_gap", "peak_gap", "ref_frames_gap")}}
    return [(k, finite_or(vals[k] if vals[k] is not None else float("inf"), 1e9),
             lim[k]) for k in NUMBERS], failed
