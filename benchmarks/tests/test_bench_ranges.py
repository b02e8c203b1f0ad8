"""The trace read by program range (`benchmarks/ranges.py`), the table of
`benchmarks/tools/range_table.py`, and the readers of the program's child
ranges, its collections and the idle under no range of its: hand-worked
numbers on a hand-made trace, None where a range or the program's range
names are absent (a program without them), and finite numbers in tiny
traced runs."""
from __future__ import annotations

import json
import math
import os

import pytest

from conftest import NOAA_SEED, ROOT, make_root, run_cell

# the five readers and the range each reads
NEW = {"psk.frontend_lowpass_s": "psk.frontend.lowpass",
       "noaa.image_groups_s": "noaa.image.lines.groups",
       "noaa.accurate_copy_s": "noaa.accurate_sync.copy",
       "host.gc_s": "host.gc",
       "device.idle_unranged_pct": None}
PROGRAM = {"psk.frontend", "psk.frontend.lowpass", "host.gc"}


def _reader(name):
    from benchmarks import harness
    return harness.load_module(os.path.join(ROOT, "benchmarks", "layers",
                                            f"{name}.py"),
                               "bench_layer_" + name.replace(".", "_"))


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": float(ts), "dur": float(dur)}


def _hand_trace() -> dict:
    """Two decodes, [0, 1000] and [1100, 1500] us; the program's
    `psk.frontend` [100, 600] holding `.lowpass` [200, 400] holding
    `host.gc` [300, 350], a driver's `noaa.get_image` [700, 900] and a
    second `psk.frontend` [1200, 1400]; kernels [0, 150], [250, 320],
    [500, 800], [1250, 1300], so the card idles over [150, 250],
    [320, 500], [800, 1250] and [1300, 1500]; launch calls at 50 (no
    range), 210, 380 (a driver call), 390, 450, 1000 (between decodes),
    1250 and 2000 (after the window), and a copy call at 220."""
    ev = [_x("user_annotation", "bench.decode", 0, 1000),
          _x("user_annotation", "bench.decode", 1100, 400),
          _x("user_annotation", "psk.frontend", 100, 500),
          _x("user_annotation", "psk.frontend.lowpass", 200, 200),
          _x("user_annotation", "host.gc", 300, 50),
          _x("user_annotation", "noaa.get_image", 700, 200),
          _x("user_annotation", "psk.frontend", 1200, 200),
          _x("kernel", "k_a", 0, 150), _x("kernel", "k_b", 250, 70),
          _x("kernel", "k_a", 500, 300), _x("kernel", "k_b", 1250, 50),
          _x("cpu_op", "aten::cat", 400, 20), _x("cpu_op", "aten::add", 820, 40)]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", t, 5)
           for t in (50, 210, 390, 450, 1000, 1250, 2000)]
    ev += [_x("cuda_driver", "cuLaunchKernel", 380, 5),
           _x("cuda_runtime", "cudaMemcpyAsync", 220, 5)]
    return {"traceEvents": ev}


def test_idle_by_range_and_launches_in_by_hand():
    from benchmarks.ranges import idle_by_range, idle_intervals, launch_times, launches_in
    from benchmarks.trace import Events
    trace = _hand_trace()
    ev, launches = Events(trace), launch_times(trace)
    assert idle_intervals(ev) == [(150, 250), (320, 500), (800, 1250), (1300, 1500)]
    got = idle_by_range(ev, PROGRAM)
    # [150, 250]: 50 in psk.frontend, 50 in .lowpass; [320, 500]: 30 in
    # host.gc, 50 in .lowpass, 100 in psk.frontend; [800, 1250]: 400
    # under the driver's range, bench.decode or nothing, 50 in the second
    # psk.frontend; [1300, 1500]: 100 in it, 100 under bench.decode alone
    want = {"psk.frontend": 300e-6, "psk.frontend.lowpass": 100e-6,
            "host.gc": 30e-6, "unranged": 500e-6}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12), k
    assert sum(got.values()) == pytest.approx(ev.window_s - ev.busy_s, abs=1e-12)
    # only the driver's range named: it takes its 100 us, the rest is
    # unranged
    drv = idle_by_range(ev, {"noaa.get_image"})
    assert drv == pytest.approx({"noaa.get_image": 100e-6, "unranged": 830e-6})
    assert idle_by_range(ev, set()) == pytest.approx({"unranged": 930e-6})
    assert launches == [50, 210, 380, 390, 450, 1000, 1250, 2000]
    assert launches_in(ev, launches, "psk.frontend.lowpass") == 3
    assert launches_in(ev, launches, "psk.frontend") == 5
    assert launches_in(ev, launches, "host.gc") == 0
    assert launches_in(ev, launches, "noaa.get_image") == 0
    assert launches_in(ev, launches, "absent") == 0


def test_idle_by_range_owner_is_breakdowns_range():
    """Ranges that overlap without nesting (`a` [0, 400], `b` [100, 1000]):
    an idle stretch where both are open goes to the shorter, `a`, the
    range `breakdown()` names the gap by; one where `b` alone is open to
    `b`."""
    from benchmarks.ranges import idle_by_range
    from benchmarks.trace import Events
    ev = Events({"traceEvents": [
        _x("user_annotation", "bench.decode", 0, 1000),
        _x("user_annotation", "a", 0, 400), _x("user_annotation", "b", 100, 900),
        _x("kernel", "k", 0, 200), _x("kernel", "k", 300, 400)]})
    # idle [200, 300] under a and b, [700, 1000] under b alone
    assert idle_by_range(ev, {"a", "b"}) == pytest.approx(
        {"a": 100e-6, "b": 300e-6, "unranged": 0.0})
    assert ev.breakdown()["idle_gaps"] == [["b host Python", pytest.approx(300e-6)],
                                           ["a host Python", pytest.approx(100e-6)]]


def test_range_table_by_hand():
    """`tools/range_table.table` on the hand trace, a decode of two: each
    program range's count, length, busy inside, idle as innermost and
    launches; the unranged idle and the window's."""
    from benchmarks.ranges import launch_times
    from benchmarks.tools.range_table import table
    from benchmarks.trace import Events
    trace = _hand_trace()
    rows = table(Events(trace), launch_times(trace), PROGRAM)
    want = {"psk.frontend": {"n": 1.0, "s": 350e-6, "busy": 135e-6,
                             "idle": 150e-6, "launches": 2.5},
            "psk.frontend.lowpass": {"n": 0.5, "s": 100e-6, "busy": 35e-6,
                                     "idle": 50e-6, "launches": 1.5},
            "host.gc": {"n": 0.5, "s": 25e-6, "busy": 10e-6, "idle": 15e-6,
                        "launches": 0.0},
            "unranged": {"idle": 250e-6},
            "window": {"decodes": 2, "idle_share": 0.62, "idle_s": 930e-6,
                       "idle_sum_s": 930e-6}}
    assert set(rows) == set(want)
    for name, row in want.items():
        assert rows[name] == pytest.approx(row, abs=1e-12), name


def test_new_readers_on_the_hand_trace(monkeypatch):
    from benchmarks.trace import Events
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "span_names", lambda: set(PROGRAM))
    ctx = {"records": [{}, {}], "events": Events(_hand_trace())}
    want = {"psk.frontend_lowpass_s": 100e-6,
            "noaa.image_groups_s": None, "noaa.accurate_copy_s": None,
            "host.gc_s": 25e-6, "device.idle_unranged_pct": 100.0 / 3}
    for name, v in want.items():
        got = _reader(name).read(ctx)
        assert got == (v if v is None else pytest.approx(v)), name


def test_new_readers_read_none_without_their_ranges(monkeypatch):
    from benchmarks.trace import Events
    from directdemod_tpu_torch.models import stages
    trace = _hand_trace()
    trace["traceEvents"] = [e for e in trace["traceEvents"]
                            if e["name"] not in set(NEW.values())]
    ctx = {"records": [{}], "events": Events(trace)}
    for name, span in NEW.items():
        if span is not None and name != "host.gc_s":
            assert _reader(name).read(ctx) is None, name
    # the collector: no collection in a program that ranges them reads 0
    assert _reader("host.gc_s").read(ctx) == 0.0
    # the collector and the idle share: a program that does not name its
    # ranges
    monkeypatch.delattr(stages, "span_names")
    assert _reader("host.gc_s").read(ctx) is None
    assert _reader("device.idle_unranged_pct").read(ctx) is None
    # no trace at all
    for name in NEW:
        assert _reader(name).read({"records": [{}], "events": None}) is None, name


@pytest.mark.parametrize("cell,seed,n", [("noaa_pass_card", NOAA_SEED, 4),
                                         ("funcube_pass_card", 2 ** 31 + 23, 3)],
                         ids=["noaa", "funcube"])
def test_traced_run_reports_the_child_range_metrics(cell, seed, n, tmp_path, capsys):
    """A tiny traced run on the CPU reports each new metric its cell lists
    as a finite number of its unit, but the idle share by range, which
    reads only where the card ran something (as `device.idle_pct`); each
    child reads less than its stage holds."""
    root = make_root(tmp_path)
    rc, res, err, _ = run_cell(root, cell, seed, 0.01, capsys, trace=True)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entries = {m["name"]: m for m in json.load(f)["per_layer"]
                   if m["name"] in NEW and cell in m["workloads"]}
    assert len(entries) == n
    got = res["metrics"]
    for name, m in entries.items():
        if name == "device.idle_unranged_pct":
            assert name not in got and "device.idle_pct" not in got
            continue
        assert got[name]["unit"] == m["unit"]
        assert math.isfinite(got[name]["value"]) and got[name]["value"] >= 0.0, name
    if cell.startswith("noaa"):
        assert got["noaa.accurate_copy_s"]["value"] < got["noaa.accurate_sync_s"]["value"]
        assert got["noaa.image_groups_s"]["value"] < (got["noaa.image_s"]["value"]
                                                      - got["noaa.image_calib_s"]["value"])
    else:
        assert got["psk.frontend_lowpass_s"]["value"] > 0.0
