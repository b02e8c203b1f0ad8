"""The port's AFSK1200 / APRS decode held to the benchmark's plain reference
(`benchmarks/reference/afsk.py`) on a seeded 4-s ISS capture of
`benchmarks/synth/afsk.py`, on the CPU: as one block (the plan of bytes held
on the decoder's device, one front-end call over the whole capture) and
through the block plan (blocks of 1,000,000 samples). The edge strength
within the configuration's `edge_gap` limit, the positive peaks equal from
the reference walk's third event on, the frames equal to the reference's
and to the planted ones, and the decoder's spans and counters against the
work the reference counts."""
import json
import os

import numpy as np
import pytest
import torch

from benchmarks.reference import afsk as ref
from benchmarks.synth import afsk as synth
from directdemod_tpu_torch import constants
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models import afsk1200 as afsk_mod
from directdemod_tpu_torch.ops import peaks

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 2 ** 31 + 20
SECONDS = 4.0


def _load(kind: str, name: str) -> dict:
    with open(os.path.join(ROOT, "benchmarks", kind, f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def capture():
    cfg = _load("configs", "aprs_afsk1200")
    traffic = _load("workloads", "aprs_pass_card")
    # short frames and preambles, so that a few fit in 4 s
    traffic.update(info_bytes=[20, 40], preamble_flags=[24, 26], first_gap_s=0.2)
    raw, frames = synth.pass_bytes(SECONDS, cfg, traffic, "cpu", SEED)
    return cfg, raw, frames, ref.decode(raw, cfg)


def _decode(cfg, raw, plan, monkeypatch):
    """The decode, its own edge strength and K2 events, and the profiler's
    ranges of the decode."""
    if plan == "blocks":
        monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 1_000_000)
        monkeypatch.setattr(afsk_mod, "device_bytes", lambda src, device=None: None)
    kept = {}
    walk = peaks.lookahead_events

    def keep(y, lookahead, *args):
        ev = walk(y, lookahead, *args)
        kept.update(edge=y.double().numpy(), events=[t.numpy() for t in ev])
        return ev
    monkeypatch.setattr(peaks, "lookahead_events", keep)
    dec = afsk_mod.Afsk1200Decoder(DeviceRawSource(raw, cfg["sample_rate"]),
                                   cfg["offset_hz"], bw=cfg["bw"], device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        frames = dec.get_frames()
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith("afsk.")]
    return dec, frames, kept, ranges


@pytest.fixture(scope="module", params=["one_block", "blocks"])
def decoded(request, capture):
    mp = pytest.MonkeyPatch()
    try:
        yield capture, _decode(capture[0], capture[1], request.param, mp)
    finally:
        mp.undo()


def _key(f):
    return (f.destination, f.source, f.path, f.control, f.protocol, f.info)


def test_capture_holds_frames(capture):
    cfg, raw, frames, want = capture
    assert raw.shape[0] == 2 * int(SECONDS * cfg["sample_rate"]) and len(frames) >= 3
    assert all(f.path == "RS0ISSp" and f.control == 3 and f.protocol == 0xF0
               for f in frames)


def test_edge_strength_matches_reference(decoded):
    (cfg, _, _, want), (_, _, kept, _) = decoded
    got = kept["edge"]
    assert got.shape == want["edge"].shape
    d = np.abs(got - want["edge"])
    rms = np.sqrt(np.mean(want["edge"] ** 2))
    assert np.percentile(d, 99.9) / rms <= cfg["limits"]["edge_gap"]


def test_positive_peaks_match_reference(decoded):
    (_, _, _, want), (_, _, kept, _) = decoded
    idx, pos, _, is_max = kept["events"]
    ref_max = [p for _, p, _, k in want["events"][2:] if k]
    got = pos[is_max.astype(bool)]
    got = got[got >= ref_max[0]]
    assert got.tolist() == ref_max
    assert len(idx) == len(want["events"])


def test_frames_match_reference_and_planted(decoded):
    (_, _, planted, want), (dec, frames, _, _) = decoded
    got = [_key(f) for f in frames]
    assert got == [tuple(f) for f in want["frames"]] == [f.key() for f in planted]
    assert dec.useful == 1


def test_counters_follow_the_work(decoded):
    (cfg, _, planted, want), (dec, _, _, _) = decoded
    c, n = dec.counters, want["counts"]
    assert c["afsk.framing.flags"] == n["flags"] >= 24 * len(planted)
    assert c["afsk.framing.crc_checks"] == n["crc_checks"] >= len(planted)
    assert c["afsk.framing.frames"] == n["frames"] == len(planted)
    assert c["afsk.framing.bauds"] == n["bauds"]
    assert c["afsk.bit_sync.samples"] == len(want["edge"]) - cfg["lookahead"]
    assert c["afsk.bit_sync.events"] == len(want["events"])


def test_one_bit_sync_stage_holds_its_children(decoded):
    """One `afsk.bit_sync` range a decode holds the filters and the walk,
    one `afsk.framing` range the levels and the host frames, and the stage
    seconds keep their three keys."""
    _, (dec, _, _, ranges) = decoded
    names = [r[0] for r in ranges]
    assert sorted(names) == sorted([
        "afsk.fm_frontend", "afsk.bit_sync", "afsk.bit_sync.filters",
        "afsk.bit_sync.walk", "afsk.framing", "afsk.framing.levels",
        "afsk.framing.frames"])
    span = {n: (a, b) for n, a, b in ranges}
    for child in ("filters", "walk"):
        a, b = span[f"afsk.bit_sync.{child}"]
        assert span["afsk.bit_sync"][0] <= a <= b <= span["afsk.bit_sync"][1]
    for child in ("levels", "frames"):
        a, b = span[f"afsk.framing.{child}"]
        assert span["afsk.framing"][0] <= a <= b <= span["afsk.framing"][1]
    assert set(dec.stage_seconds) == {"fm_frontend", "bit_sync", "framing"}
