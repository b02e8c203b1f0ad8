"""The decoders' spans and counters (`directdemod_tpu_torch.models.stages`)
in a CPU `torch.profiler` trace.

Stated checks (exact): a NOAA decode of the 12-line `tests.apt_synth`
capture held as raw bytes (`DeviceRawSource`, the resident path) puts every
stage and child span in the trace, each child inside its parent; its
candidate counter equals the samples above the thresholds of the one
`ops.peaks.group_peaks_dense` call (its arguments' `(cor > thr).sum()`),
its rows counter the two rows that call grouped and its sync counter the
syncs it kept; a Funcube decode on the block loop opens one
`psk.pass2.symbols` span a block and one `psk.pass2.correlate` span a
counted device batch (`psk.pass2.batches`, at most one a block); an
AFSK decode runs one CRC pass (`ops.crc.fcs_crc16_check`) over as many
segments as the per-bit framing loop checks, whether or not any is; with
no profiler the session's tally stays as it was; two sessions keep two
tallies; a stage whose body raises closes its range
and keeps its time. Child ranges: one `psk.frontend.lowpass` a block inside
`psk.frontend`; `noaa.image.lines.groups` inside `noaa.image.lines` (in the
bank inside `noaa_bank.image`); one `noaa.accurate_sync.copy` a batch
inside `noaa.accurate_sync` (in the bank inside `noaa_bank.accurate_sync`),
as many as the accurate sync's batches of windows; every resample of the
image's line groups inside `noaa.image.lines.groups`. The collector: a
`gc.collect()` in a session is one `host.gc` range and no count; with no
profiler no hook is in `gc.callbacks`, and one left by a session records
nothing and goes at the next call.
"""
import gc
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke as cs
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models import apt, noaa, stages
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.noaa import WINDOW_GROUP, NoaaDecoder
from directdemod_tpu_torch.ops import crc, peaks, resample as rs
from benchmarks.synth import apt_bank
from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder
from tests.apt_synth import FS, synthesize
from tests.test_torch_afsk import oracle_frames

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the test's own range around each `ops.resample.fft_resample` call
PROBE = "test.fft_resample"

NOAA_STAGES = {"fm_frontend", "crude_sync", "image", "accurate_sync"}
# child span -> its parent stage's range
NOAA_CHILDREN = {"noaa.crude_sync.copy": "noaa.crude_sync",
                 "noaa.crude_sync.group": "noaa.crude_sync",
                 "noaa.image.lines": "noaa.image",
                 "noaa.image.calibration": "noaa.image"}
PSK_CHILDREN = ("psk.pass2.symbols", "psk.pass2.window", "psk.pass2.correlate")
FC_BLOCK = 4_000_000


class _Toy(stages.TimedDecoder):
    layer = "toy"

    def __init__(self):
        self._init_device("cpu")


def _profile():
    # the tally restarts where a call finds a profiler recording after one
    # that found none: read it once outside, so that a session an earlier
    # test in this process left behind ends here
    stages.session_counts()
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof, path) -> list:
    """(name, start, end) of every range the trace marks, in microseconds."""
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _named(ranges, name) -> list:
    return [(s, e) for n, s, e in ranges if n == name]


def _inside(child, parents) -> bool:
    s, e = child
    return any(ps <= s and e <= pe for ps, pe in parents)


def _raw(iq: np.ndarray) -> torch.Tensor:
    raw = np.empty(2 * len(iq), np.uint8)
    raw[0::2] = np.round(iq.real + 127.5).astype(np.uint8)
    raw[1::2] = np.round(iq.imag + 127.5).astype(np.uint8)
    return torch.from_numpy(raw)


@pytest.fixture(scope="module")
def noaa_traced(tmp_path_factory):
    """The decode under a profiler, `group_peaks_dense` wrapped to count
    the samples above the thresholds it is given."""
    iq, _ = synthesize(n_lines=12, snr_db=20)
    returned, images, windows = [], [], []
    orig, image_stage = peaks.group_peaks_dense, apt.image_stage
    starts, resample = noaa.window_starts, rs.fft_resample

    def counting(cor, threshold, min_dist):
        returned.append(int((cor > threshold.reshape(-1, 1)).sum()))
        return orig(cor, threshold, min_dist)

    def keeping(*args):
        images.append(args)
        return image_stage(*args)

    def windowing(*args):
        out = starts(*args)
        windows.append(len(out))
        return out

    def probed(*args, **kw):
        with torch.profiler.record_function(PROBE):
            return resample(*args, **kw)

    peaks.group_peaks_dense = counting
    apt.image_stage = keeping
    noaa.window_starts = windowing
    rs.fft_resample = probed
    try:
        dec = NoaaDecoder(DeviceRawSource(_raw(iq), FS), 30000, device="cpu")
        with _profile() as prof:
            assert dec.useful == 1
            dec.get_image()
            dec.get_accurate_sync()
    finally:
        peaks.group_peaks_dense = orig
        apt.image_stage = image_stage
        noaa.window_starts = starts
        rs.fft_resample = resample
    tally, names = stages.session_counts(), stages.span_names()
    return {"dec": dec, "returned": returned, "tally": tally, "images": images,
            "windows": windows, "names": names,
            "ranges": _ranges(prof, tmp_path_factory.mktemp("noaa") / "t.json")}


@pytest.fixture(scope="module")
def funcube_traced(tmp_path_factory):
    raw, starts = cs.synth_funcube_bytes(11.0, "cpu", seed=5)
    dec = FuncubeDecoder(DeviceRawSource(raw, cs.FS), cs.FC_OFFSET_HZ,
                         block_size=FC_BLOCK, device="cpu")
    with _profile() as prof:
        syncs = dec.get_syncs()
    assert dec.useful == 1 and len(syncs) == len(starts) - 1
    return {"dec": dec, "blocks": -(-raw.shape[0] // 2 // FC_BLOCK),
            "ranges": _ranges(prof, tmp_path_factory.mktemp("fc") / "t.json")}


def test_noaa_spans_nest_in_their_stages(noaa_traced):
    ranges = noaa_traced["ranges"]
    assert set(noaa_traced["dec"].stage_seconds) == NOAA_STAGES
    for stage in NOAA_STAGES:
        assert len(_named(ranges, f"noaa.{stage}")) == 1, stage
    for child, parent in NOAA_CHILDREN.items():
        got = _named(ranges, child)
        assert len(got) == 1, child
        assert _inside(got[0], _named(ranges, parent)), (child, parent)


def test_noaa_counters_count_candidates_and_syncs(noaa_traced):
    dec, returned = noaa_traced["dec"], noaa_traced["returned"]
    sa, sb = dec.get_crude_sync()
    assert len(returned) == 1 and sum(returned) > len(sa) + len(sb) > 0
    assert dec.counters == {"noaa.crude_sync.candidates": sum(returned),
                            "noaa.crude_sync.device_rows": 2,
                            "noaa.crude_sync.syncs": len(sa) + len(sb)}
    # the whole decode ran under the session; beside the decoder's counters
    # the tally holds the IIR constants' two lookups (the image band-pass,
    # forward and backward)
    tally = dict(noaa_traced["tally"])
    lookups = tally.pop("iir.constants.built", 0) + tally.pop("iir.constants.reused", 0)
    assert tally == dec.counters
    assert lookups == 2


def test_funcube_block_loop_spans(funcube_traced):
    ranges, dec = funcube_traced["ranges"], funcube_traced["dec"]
    blocks = funcube_traced["blocks"]
    assert blocks > 1
    pass2 = _named(ranges, "psk.pass2")
    assert len(pass2) == len(_named(ranges, "psk.symbol_scan")) == blocks
    assert len(_named(ranges, "psk.pass2.symbols")) == blocks
    n_corr = dec.counters["psk.pass2.correlations"]
    n_batch = dec.counters["psk.pass2.batches"]
    assert n_corr >= 1 and 1 <= n_batch <= min(n_corr, blocks)
    # one correlate range a device batch, one window range a batch or more
    # (a block whose only window is a stale snapshot gathers it, and
    # correlates nothing)
    assert len(_named(ranges, "psk.pass2.correlate")) == n_batch
    assert len(_named(ranges, "psk.pass2.window")) >= n_batch
    assert dec.counters["psk.pass2.windows"] >= n_corr
    assert dec.counters["psk.pass2.minsyncs"] >= n_corr
    for child in PSK_CHILDREN:
        for r in _named(ranges, child):
            assert _inside(r, pass2), child


@pytest.mark.parametrize("seconds,batches", [(3.0, 1), (0.2, 0)])
def test_afsk_crc_batches_counter(seconds, batches, monkeypatch):
    """A decode of frames (3 s) and one of flags alone (0.2 s: no frame
    fits): one CRC pass a decode over the per-bit loop's checks, which
    are some (`batches` 1) or none (0), and the loop's frames."""
    raw, infos = cs.synth_aprs_bytes(seconds, "cpu", seed=3)
    dec = Afsk1200Decoder(DeviceRawSource(raw, cs.FS), cs.APRS_OFFSET_HZ, device="cpu")
    levels, passes = [], []
    frames_from = dec._frames_from_nrzi
    check = crc.fcs_crc16_check

    def keeping(nrzi):
        levels.append(nrzi)
        return frames_from(nrzi)

    def counting(data, seg_counts):
        passes.append(len(seg_counts))
        return check(data, seg_counts)

    dec._frames_from_nrzi = keeping
    monkeypatch.setattr(crc, "fcs_crc16_check", counting)
    with _profile():
        frames = dec.get_frames()
    tally = stages.session_counts()
    want, counts = oracle_frames(levels[0])
    assert [f.info for f in frames] == [f.info for f in want] == infos
    assert tally["afsk.framing.crc_checks"] == counts["afsk.framing.crc_checks"]
    assert passes == [counts["afsk.framing.crc_checks"]]
    assert (counts["afsk.framing.crc_checks"] > 0) == (batches == 1)
    assert "afsk.framing.crc_batches" not in tally
    assert "afsk.framing.crc_batches" not in dec.counters


def test_no_profiler_leaves_the_tally(noaa_traced):
    before = stages.session_counts()        # the last session's, counted
    assert before
    iq, _ = synthesize(n_lines=12, snr_db=20)
    dec = NoaaDecoder(DeviceRawSource(_raw(iq), FS), 30000, device="cpu")
    dec.get_image()
    dec.get_accurate_sync()
    assert stages.session_counts() == before
    assert set(dec.stage_seconds) == NOAA_STAGES
    assert dec.counters["noaa.crude_sync.candidates"] > 0


def test_two_sessions_keep_two_tallies():
    toy = _Toy()
    tallies = []
    for n in (3, 5):
        with _profile():
            toy._count("stage.things", n)
            with toy._stage("stage"):
                toy._count("stage.things", 1)
        tallies.append(stages.session_counts())
    assert tallies == [{"toy.stage.things": 4}, {"toy.stage.things": 6}]
    assert toy.counters == {"toy.stage.things": 10}
    with _profile():
        assert stages.session_counts() == {}


def test_a_stage_that_raises_closes_its_range(tmp_path):
    toy = _Toy()
    with _profile() as prof:
        with pytest.raises(ValueError):
            with toy._stage("boom"):
                with toy._span("boom.inner"):
                    raise ValueError("x")
        with toy._stage("after"):
            pass
    ranges = _ranges(prof, tmp_path / "t.json")
    (boom,), (inner,), (after,) = (_named(ranges, n) for n in
                                   ("toy.boom", "toy.boom.inner", "toy.after"))
    assert _inside(inner, [boom]) and after[0] >= boom[1]
    assert set(toy.stage_seconds) == {"boom", "after"}
    assert toy.stage_seconds["boom"] >= 0.0


def test_noaa_groups_and_copy_ranges_nest(noaa_traced):
    """One `noaa.image.lines.groups` range inside `noaa.image.lines`, one
    `noaa.accurate_sync.copy` range a batch inside `noaa.accurate_sync`,
    and `span_names()` names every range of the trace but the test's own
    (the program opened them all)."""
    ranges, windows = noaa_traced["ranges"], noaa_traced["windows"]
    (groups,) = _named(ranges, "noaa.image.lines.groups")
    assert _inside(groups, _named(ranges, "noaa.image.lines"))
    copies = _named(ranges, "noaa.accurate_sync.copy")
    # A and B: a batch or more each
    assert len(copies) == sum(-(-n // WINDOW_GROUP) for n in windows) >= 2
    for r in copies:
        assert _inside(r, _named(ranges, "noaa.accurate_sync"))
    assert noaa_traced["names"] == {n for n, _, _ in ranges} - {PROBE}


def test_noaa_image_groups_hold_every_resample(noaa_traced):
    """Each line length of a resampled width (a unit or more) is one
    `fft_resample` call, and each sits inside `noaa.image.lines.groups`;
    no resample of the front end's falls in it."""
    (args,) = noaa_traced["images"]
    unit, spans = args[5], list(args[6]) + list(args[7])
    ranges = noaa_traced["ranges"]
    (groups,) = _named(ranges, "noaa.image.lines.groups")
    inside = [r for r in _named(ranges, PROBE) if _inside(r, [groups])]
    assert len(inside) == len({max(e - s, 0) for s, e in spans
                               if max(e - s, 0) >= unit}) >= 1


def test_psk_lowpass_range_once_a_block(funcube_traced):
    ranges, blocks = funcube_traced["ranges"], funcube_traced["blocks"]
    frontend = _named(ranges, "psk.frontend")
    lowpass = _named(ranges, "psk.frontend.lowpass")
    assert len(lowpass) == len(frontend) == blocks
    for r in lowpass:
        assert _inside(r, frontend)


def test_bank_accurate_copy_inside_the_bank_stage(tmp_path):
    """In the bank the accurate sync's copy (`noaa.fast_rows`) sits inside
    `noaa_bank.accurate_sync`, one a shared batch, and a channel's line
    groups inside `noaa_bank.image`."""
    with open(os.path.join(ROOT, "benchmarks", "configs", "noaa_apt_3sat.json")) as f:
        cfg = json.load(f)
    raw, _ = apt_bank.pass_bytes(8, cfg, 0.05, "cpu", 2 ** 31 + 24)
    dec = NoaaBankDecoder(DeviceRawSource(raw, FS),
                          [ch["offset_hz"] for ch in cfg["channels"]], device="cpu")
    with _profile() as prof:
        dec.channels[0].get_image()
        dec.channels[0].get_accurate_sync()
    ranges = _ranges(prof, tmp_path / "t.json")
    copies = _named(ranges, "noaa.accurate_sync.copy")
    assert len(copies) == dec.counters["noaa_bank.accurate_sync.batches"] >= 1
    for r in copies:
        assert _inside(r, _named(ranges, "noaa_bank.accurate_sync"))
    assert not _named(ranges, "noaa.accurate_sync")
    imaged = sum(u or i == 0 for i, u in enumerate(dec.useful))
    groups = _named(ranges, "noaa.image.lines.groups")
    assert len(groups) == imaged >= 1
    for r in groups:
        assert _inside(r, _named(ranges, "noaa_bank.image"))


def test_a_collection_is_a_range(tmp_path):
    """With the collector's own runs off, a `gc.collect()` inside a stage
    of a session is one `host.gc` range inside that stage's and a name of
    the program's, and counts nothing."""
    toy = _Toy()
    gc.disable()
    try:
        with _profile() as prof:
            with toy._stage("outer"):
                gc.collect()
        tally, names = stages.session_counts(), stages.span_names()
    finally:
        gc.enable()
    ranges = _ranges(prof, tmp_path / "t.json")
    (collection,) = _named(ranges, "host.gc")
    assert _inside(collection, _named(ranges, "toy.outer"))
    assert tally == {}
    assert names == {"toy.outer", "host.gc"}


def test_no_profiler_no_gc_hook():
    """With no profiler the program's calls leave no hook in
    `gc.callbacks`, and a collection records nothing."""
    stages.session_counts()      # end a session an earlier test left behind
    before, names = stages.session_counts(), stages.span_names()
    toy = _Toy()
    with toy._stage("stage"):
        with toy._span("stage.child"):
            gc.collect()
        toy._count("stage.things", 1)
    assert stages._gc_hook not in gc.callbacks
    assert stages.session_counts() == before
    assert stages.span_names() == names


def test_a_hook_left_by_a_session_goes_at_the_next_call():
    """A session that ends with no call of the program after it leaves
    the hook in, which records nothing; the next call, finding no
    profiler, takes it out."""
    toy = _Toy()
    with _profile():
        with toy._stage("stage"):
            assert gc.callbacks.count(stages._gc_hook) == 1
    assert gc.callbacks.count(stages._gc_hook) == 1
    names = set(stages._session["names"])
    gc.collect()
    assert stages._session["gc"] is None and stages._session["names"] == names
    with toy._stage("after"):
        pass
    assert stages._gc_hook not in gc.callbacks
