"""The readers of the program's spans and counters: a traced run of each
cell at tiny sizes reports each as a finite number of its unit, and each
reads None where its span or counter is absent (a program without them)."""
from __future__ import annotations

import json
import math
import os

import pytest

from conftest import NOAA_SEED, ROOT, make_root, run_cell
from test_bench_faults import _fc_blocks

SPANS = {"noaa.crude_copy_s": "noaa.crude_sync.copy",
         "noaa.crude_group_s": "noaa.crude_sync.group",
         "noaa.image_calib_s": "noaa.image.calibration",
         "psk.pass2_window_s": "psk.pass2.window",
         "psk.pass2_correlate_s": "psk.pass2.correlate"}
COUNTERS = {"noaa.crude_candidates": "noaa.crude_sync.candidates",
            "psk.correlations": "psk.pass2.correlations"}


def _manifest_entries(cell) -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    return {m["name"]: m for m in manifest["per_layer"]
            if m["name"] in {**SPANS, **COUNTERS} and cell in m["workloads"]}


def _reader(name):
    from benchmarks import harness
    return harness.load_module(os.path.join(ROOT, "benchmarks", "layers",
                                            f"{name}.py"),
                               "bench_layer_" + name.replace(".", "_"))


@pytest.mark.parametrize("cell,seed,blocks", [
    ("noaa_pass_card", NOAA_SEED, False),
    ("funcube_pass_card", 2 ** 31 + 23, False),
    ("funcube_pass_card", 2 ** 31 + 23, True)],
    ids=["noaa", "funcube_whole_capture", "funcube_block_loop"])
def test_traced_run_reports_each_new_metric(cell, seed, blocks, tmp_path,
                                            monkeypatch, capsys):
    root = _fc_blocks(tmp_path, monkeypatch) if blocks else make_root(tmp_path)
    rc, res, err, _ = run_cell(root, cell, seed, 0.01, capsys, trace=True)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    entries = _manifest_entries(cell)
    assert len(entries) == (4 if cell.startswith("noaa") else 3)
    for name, m in entries.items():
        got = res["metrics"][name]
        assert got["unit"] == m["unit"]
        assert math.isfinite(got["value"]) and got["value"] >= 0.0, name
        if name in COUNTERS:
            assert got["value"] >= 1.0, name
    if cell.startswith("funcube"):
        # a tiny pass holds two planted frames: one correlation each
        assert res["metrics"]["psk.correlations"]["value"] == 2.0


def test_readers_read_none_without_their_spans_and_counters(monkeypatch):
    import torch
    from benchmarks.trace import Events
    from directdemod_tpu_torch.models import stages
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.decode",
         "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "noaa.crude_sync",
         "ts": 10.0, "dur": 500.0}]}
    ctx = {"records": [{}], "events": Events(trace)}
    for name in SPANS:
        assert _reader(name).read(ctx) is None, name
    # a session in which the program ran a stage and counted nothing
    toy = stages.TimedDecoder()
    toy.layer = "toy"
    toy._init_device("cpu")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with toy._stage("stage"):
            pass
    assert stages.session_counts() == {}
    for name in COUNTERS:
        assert _reader(name).read(ctx) is None, name
    # a program that keeps no tally
    monkeypatch.delattr(stages, "session_counts")
    for name in COUNTERS:
        assert _reader(name).read(ctx) is None, name


def test_span_readers_clip_to_the_window_and_divide_by_decodes():
    from benchmarks.trace import Events
    events = [{"ph": "X", "cat": "user_annotation", "name": "bench.decode",
               "ts": 100.0, "dur": 900.0}]
    for i, span in enumerate(SPANS.values()):
        # 0.5 ms inside, and a span straddling the window's start by 50 us
        events += [{"ph": "X", "cat": "user_annotation", "name": span,
                    "ts": 200.0 + i, "dur": 500.0},
                   {"ph": "X", "cat": "user_annotation", "name": span,
                    "ts": 50.0, "dur": 100.0}]
    ctx = {"records": [{}, {}], "events": Events({"traceEvents": events})}
    for name in SPANS:
        assert _reader(name).read(ctx) == pytest.approx(550e-6 / 2), name
