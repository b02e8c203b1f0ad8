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
AFSK decode counts one batched CRC pass (`afsk.framing.crc_batches`) where
any segment is checked, none where none is, and as many checks as the
per-bit framing loop; with no profiler the session's tally stays as it was;
two sessions keep two tallies; a stage whose body raises closes its range
and keeps its time.
"""
import json

import numpy as np
import pytest
import torch

import chip_smoke as cs
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models import stages
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from directdemod_tpu_torch.ops import peaks
from tests.apt_synth import FS, synthesize
from tests.test_torch_afsk import oracle_frames

torch.set_num_threads(1)

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
    returned = []
    orig = peaks.group_peaks_dense

    def counting(cor, threshold, min_dist):
        returned.append(int((cor > threshold.reshape(-1, 1)).sum()))
        return orig(cor, threshold, min_dist)

    peaks.group_peaks_dense = counting
    try:
        dec = NoaaDecoder(DeviceRawSource(_raw(iq), FS), 30000, device="cpu")
        with _profile() as prof:
            assert dec.useful == 1
            dec.get_image()
            dec.get_accurate_sync()
    finally:
        peaks.group_peaks_dense = orig
    tally = stages.session_counts()
    return {"dec": dec, "returned": returned, "tally": tally,
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
def test_afsk_crc_batches_counter(seconds, batches):
    """A decode of frames (3 s) and one of flags alone (0.2 s: no frame
    fits): one CRC batch where any segment is checked, with the per-bit
    loop's checks and frames, and none where none is."""
    raw, infos = cs.synth_aprs_bytes(seconds, "cpu", seed=3)
    dec = Afsk1200Decoder(DeviceRawSource(raw, cs.FS), cs.APRS_OFFSET_HZ, device="cpu")
    levels = []
    frames_from = dec._frames_from_nrzi

    def keeping(nrzi):
        levels.append(nrzi)
        return frames_from(nrzi)

    dec._frames_from_nrzi = keeping
    with _profile():
        frames = dec.get_frames()
    tally = stages.session_counts()
    want, counts = oracle_frames(levels[0])
    assert [f.info for f in frames] == [f.info for f in want] == infos
    assert tally["afsk.framing.crc_checks"] == counts["afsk.framing.crc_checks"]
    assert tally["afsk.framing.crc_batches"] == batches
    assert (counts["afsk.framing.crc_checks"] > 0) == (batches == 1)
    assert dec.counters["afsk.framing.crc_batches"] == batches


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
