"""The port's stage counters and profiler hook (`directdemod_tpu_torch.utils.
profiling`) against the JAX module's (`directdemod_tpu.utils.profiling`).

Stated checks (exact): the same `stage` calls give the same samples, calls
and `report()` keys in both; `wall_clock` and `log_report` log; `trace`
writes a Chrome trace on the CPU; `NoaaDecoder(ArraySource).profiler`
reports the JAX decoder's stage names, samples and calls on the same
12-line `tests.apt_synth` capture, on the blocked and mesh paths; on the
resident path, where the JAX decoder fuses two stages into one, the port's
front-end stage has the fused stage's samples.
"""
import json
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import DeviceRawSource as JDeviceRawSource
from directdemod_tpu.models.noaa import NoaaDecoder as JNoaaDecoder
from directdemod_tpu.parallel.mesh import make_mesh as jmake_mesh
from directdemod_tpu.utils import profiling as jprof
from directdemod_tpu_torch.io.sources import ArraySource, DeviceRawSource
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from directdemod_tpu_torch.parallel.mesh import make_mesh
from directdemod_tpu_torch.utils import profiling as prof
from tests.apt_synth import FS, synthesize

torch.set_num_threads(1)

CALLS = [("fm_frontend", 1000), ("fm_frontend", 24), ("sync_correlate", 7), ("idle", 0)]


def _drive(p):
    for name, n in CALLS:
        with p.stage(name, n):
            pass
    return p


def test_profiler_counts_match_jax():
    ours, theirs = _drive(prof.Profiler()), _drive(jprof.Profiler())
    r, t = ours.report(), theirs.report()
    assert list(r) == list(t) == ["fm_frontend", "sync_correlate", "idle"]
    for name in r:
        assert set(r[name]) == set(t[name]) == {"msamples_per_s", "samples",
                                                "seconds", "calls"}
        assert (r[name]["samples"], r[name]["calls"]) == (t[name]["samples"],
                                                          t[name]["calls"])
    assert (r["fm_frontend"]["samples"], r["fm_frontend"]["calls"]) == (1024, 2)
    assert r["idle"]["msamples_per_s"] >= 0.0


def test_stage_counts_when_the_region_raises():
    p = prof.Profiler()
    with pytest.raises(KeyError):
        with p.stage("boom", 5):
            raise KeyError("x")
    assert p.report()["boom"]["samples"] == 5 and p.report()["boom"]["calls"] == 1


def test_stage_stats_rate_and_rounding():
    st = prof.StageStats(samples=3_000_000, seconds=2.0, calls=1)
    assert st.msamples_per_s == 1.5 and prof.StageStats().msamples_per_s == 0.0
    p = prof.Profiler()
    p.stages["a"] = prof.StageStats(samples=1, seconds=0.123456789, calls=1)
    jp = jprof.Profiler()
    jp.stages["a"] = jprof.StageStats(samples=1, seconds=0.123456789, calls=1)
    assert p.report() == jp.report() == {"a": {"msamples_per_s": 0.0, "samples": 1,
                                               "seconds": 0.1235, "calls": 1}}


def test_wall_clock_and_log_report_log(caplog):
    with caplog.at_level(logging.INFO, logger=prof.__name__):
        with prof.wall_clock("region"):
            pass
        _drive(prof.Profiler()).log_report()
    text = caplog.text
    assert "region took" in text
    assert "stage fm_frontend" in text and "(1024 samples, 2 calls)" in text


def test_trace_writes_a_chrome_trace(tmp_path):
    with prof.trace(str(tmp_path)) as p:
        torch.arange(1000.0).cumsum(0).sum()
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    assert any("cumsum" in e.key for e in p.key_averages())


@pytest.fixture(scope="module")
def capture():
    iq, _ = synthesize(n_lines=12, snr_db=20)
    return iq


def _decode(dec):
    dec.get_crude_sync()
    dec.get_audio()
    return {name: (r["samples"], r["calls"]) for name, r in dec.profiler.report().items()}


@pytest.mark.parametrize("path", ["blocked", "mesh"])
def test_noaa_profiler_matches_jax(capture, path):
    """The blocked feed (a stage a block) and the mesh front end (one
    stage of the capture's length): the port's stage names, samples and
    calls equal the JAX decoder's."""
    mesh, jmesh = (make_mesh(time=8, device="cpu"), jmake_mesh(time=8)) \
        if path == "mesh" else (None, None)
    ours = _decode(NoaaDecoder(ArraySource(capture, FS), 30000, device="cpu", mesh=mesh))
    theirs = _decode(JNoaaDecoder(JArraySource(capture, FS), 30000, mesh=jmesh))
    assert ours == theirs
    assert set(ours) == {"fm_frontend", "sync_correlate"}
    assert ours["sync_correlate"][0] > 0 and ours["fm_frontend"][0] >= len(capture)


def test_noaa_profiler_on_the_resident_path(capture):
    """A capture of raw bytes held on the decoder's device: the JAX decoder
    records its fused crude-sync path as one "frontend+sync" stage of the
    capture's length; the port runs two stages and records "fm_frontend"
    with that length and "sync_correlate" with 2 n audio samples."""
    raw = np.empty(2 * len(capture), np.uint8)
    raw[0::2] = np.clip(np.round(capture.real * 60 + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(capture.imag * 60 + 127.5), 0, 255)
    dec = NoaaDecoder(DeviceRawSource(torch.from_numpy(raw), FS), 30000, device="cpu")
    dec.get_crude_sync()
    audio_len = int(dec._audio[0].shape[0])
    jdec = JNoaaDecoder(JDeviceRawSource(jnp.asarray(raw), FS), 30000)
    jdec.get_crude_sync()
    ours, theirs = dec.profiler.report(), jdec.profiler.report()
    assert list(theirs) == ["frontend+sync"]
    assert ours["fm_frontend"]["samples"] == theirs["frontend+sync"]["samples"] == len(capture)
    assert ours["sync_correlate"]["samples"] == 2 * audio_len
    assert [r["calls"] for r in ours.values()] == [1, 1]
