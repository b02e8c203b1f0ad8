"""The harness finds every part of a cell by name, takes a new cell made of
new files only, and keeps its window arithmetic: whole decodes, the rate
over the true window, the 95th percentile of every decode's wall."""
from __future__ import annotations

import json
import os
import re

import numpy as np
import pytest

from conftest import BENCH, ROOT, make_root, run_cell

TOY_DRIVER = '''
import time

def setup(cfg, traffic, seed, device, workdir):
    return {"walls": list(traffic["walls"]), "i": 0, "cap": traffic["capture_s"]}

def decode_once(st, sample):
    w = st["walls"][st["i"] % len(st["walls"])]
    st["i"] += 1
    time.sleep(w)
    return {"slept": w, "stage_seconds": {"all": w}}

def capture_seconds(st):
    return st["cap"]

def release(st):
    pass

def check(st, records):
    bad = sum(r["slept"] < 0 for r in records)
    return [("negative_sleeps", float(bad), 0.0)], bad
'''

TOY_LAYER = '''
def read(ctx):
    v = [r["stage_seconds"]["all"] for r in ctx["records"]]
    return sum(v) / len(v) if v else None
'''


def test_every_cell_resolves_by_name():
    from benchmarks import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        spec = harness.resolve(ROOT, w["name"])
        assert os.path.isfile(spec["driver"])
        assert spec["cfg"]["name"] == w["config"]
        assert os.path.isfile(os.path.join(ROOT, configs[w["config"]]["file"]))
        for m in spec["per_layer"]:
            assert os.path.isfile(os.path.join(BENCH, "layers", m["name"] + ".py"))
        names = {m["name"] for m in spec["end_to_end"]}
        assert {"setup_s", "realtime_x"} <= names
        assert spec["per_layer"], w["name"]
    for m in manifest["per_layer"]:
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}


def _toy_root(tmp_path, walls, capture_s=2.0):
    root = make_root(tmp_path, extra_cells=[(
        {"name": "toy_cell", "config": "toy", "traffic": "toy_cell", "chips": 1,
         "why": "a throwaway cell"},
        {"config": "toy", "walls": walls, "capture_s": capture_s,
         "_per_layer": [{"name": "toy.decode_s", "unit": "s", "better": "lower",
                         "source": "program_span", "layer": "toy",
                         "moves": "realtime_x", "workloads": ["toy_cell"]}]})])
    b = os.path.join(root, "benchmarks")
    with open(os.path.join(b, "configs", "toy.json"), "w") as f:
        json.dump({"name": "toy", "driver": "toy"}, f)
    with open(os.path.join(b, "drivers", "toy.py"), "w") as f:
        f.write(TOY_DRIVER)
    with open(os.path.join(b, "layers", "toy.decode_s.py"), "w") as f:
        f.write(TOY_LAYER)
    return root


def test_new_cell_from_new_files_only(tmp_path, capsys):
    before = {p: os.path.getmtime(os.path.join(dp, p))
              for dp, _, fs in os.walk(BENCH) for p in fs}
    root = _toy_root(tmp_path, [0.02])
    rc, res, err, _ = run_cell(root, "toy_cell", 7, 0.1, capsys, trace=True)
    assert rc == 0 and res["correct"] is True
    assert res["metrics"]["toy.decode_s"]["unit"] == "s"
    assert res["metrics"]["toy.decode_s"]["value"] == pytest.approx(0.02, rel=0.5)
    assert list(res)[-1] == "checks"
    after = {p: os.path.getmtime(os.path.join(dp, p))
             for dp, _, fs in os.walk(BENCH) for p in fs if p in before}
    assert after == {p: before[p] for p in after}


def test_window_holds_whole_decodes(tmp_path, capsys):
    walls = [0.03, 0.06, 0.03, 0.09]
    root = _toy_root(tmp_path, walls, capture_s=3.0)
    rc, res, _, out = run_cell(root, "toy_cell", 11, 0.25, capsys)
    assert rc == 0
    n = res["attempted"]
    # the warm-up took walls[0]; the window starts decodes while under
    # 0.25 s, so it ends with a whole decode
    planned = np.cumsum([walls[(i + 1) % len(walls)] for i in range(n)])
    assert planned[-2] < 0.25 <= planned[-1] + 0.05
    m = re.search(r"window ([0-9.e-]+) s, (\d+) decodes of ([0-9.]+) s, walls (\[.*\])",
                  out)
    window, got = float(m.group(1)), json.loads(m.group(4))
    assert int(m.group(2)) == n == len(got)
    assert planned[-1] <= window < planned[-1] + 0.05
    # the rate: all the capture over all the window
    assert res["metrics"]["realtime_x"]["value"] == pytest.approx(n * 3.0 / window,
                                                                rel=1e-9)


def test_p95_hand_worked():
    from benchmarks import harness
    # 21 walls 1..21 s: the 95th percentile sits at rank 0.95 * 20 = 19
    assert harness.percentile(list(range(1, 22)), 95) == 20.0
    # 40 walls: rank 0.95 * 39 = 37.05, between the 38th and 39th smallest
    walls = [1.0] * 37 + [2.0, 3.0, 4.0]
    assert harness.percentile(walls, 95) == pytest.approx(2.0 + 0.05 * 1.0)


def test_result_line_and_checks_last(tmp_path, capsys):
    root = _toy_root(tmp_path, [0.01])
    from benchmarks import harness
    import time
    rc = harness.run(root, "toy_cell", 3, 0.05, False, time.perf_counter(),
                     device="cpu")
    out, err = capsys.readouterr()
    assert rc == 0
    last = out.strip().splitlines()[-1]
    res = json.loads(last)
    assert set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(res)[-1] == "checks"
    # the numbers compared, each beside its limit, are stderr's last lines
    tail = err.strip().splitlines()[-2:]
    assert tail[0].startswith("correct True")
    assert re.fullmatch(r"check negative_sleeps: 0\.0 \(limit 0\.0\) ok", tail[1])
