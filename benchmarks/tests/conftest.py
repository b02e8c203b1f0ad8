"""Fixtures of the benchmark's CPU tests: a checkout-like root whose cells
are the benchmark's own at tiny sizes, made of temporary files beside
links to the benchmark's configurations, drivers and metric readers."""
from __future__ import annotations

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# tiny sizes: a 12.25 s NOAA pass (24 lines) and an 11 s Funcube pass (two
# planted frames, so one reported sync)
TINY = {"lines": 24, "seconds": 11.0}
# the telemetry frame at 2 lines a wedge, so that a tiny pass can hold the
# wedges' whole walk (on seed NOAA_SEED, whose frame starts where it fits)
TINY_CONFIGS = {"noaa_apt": {"telemetry": {"wedge_lines": 2, "frame_lines": 32}}}
NOAA_SEED = 2 ** 31 + 10


def make_root(path, extra_cells=(), tiny=True) -> str:
    """A root at `path` holding BENCHMARK.json (with `extra_cells` appended
    as (manifest entry, traffic) pairs) and benchmarks/ with the workloads
    written anew (at TINY sizes, the configurations of TINY_CONFIGS
    changed) and the rest linked."""
    root = str(path)
    os.makedirs(os.path.join(root, "benchmarks", "workloads"), exist_ok=True)
    for d in ("configs", "drivers", "layers"):
        os.makedirs(os.path.join(root, "benchmarks", d), exist_ok=True)
        for name in os.listdir(os.path.join(BENCH, d)):
            dst = os.path.join(root, "benchmarks", d, name)
            if not os.path.exists(dst):
                os.symlink(os.path.join(BENCH, d, name), dst)
    for name, change in TINY_CONFIGS.items() if tiny else ():
        dst = os.path.join(root, "benchmarks", "configs", f"{name}.json")
        with open(dst) as f:
            cfg = json.load(f)
        for k, v in change.items():
            cfg[k] = {**cfg[k], **v}
        os.remove(dst)
        with open(dst, "w") as f:
            json.dump(cfg, f)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for w in manifest["workloads"]:
        with open(os.path.join(BENCH, "workloads", f"{w['name']}.json")) as f:
            t = json.load(f)
        if tiny:
            t.update({k: v for k, v in TINY.items() if k in t})
        with open(os.path.join(root, "benchmarks", "workloads",
                               f"{w['name']}.json"), "w") as f:
            json.dump(t, f)
    for entry, traffic in extra_cells:
        manifest["workloads"].append(entry)
        manifest["per_layer"] += traffic.pop("_per_layer", [])
        manifest["configs"] += traffic.pop("_configs", [])
        with open(os.path.join(root, "benchmarks", "workloads",
                               f"{entry['name']}.json"), "w") as f:
            json.dump(traffic, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    return root


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def run_cell(root, workload, seed, seconds, capsys, trace=False):
    """One harness run on the CPU; returns (exit code, result line or
    None, standard error, standard output)."""
    import time
    import torch
    from benchmarks import harness
    torch.set_num_threads(2)
    rc = harness.run(root, workload, seed, seconds, trace, time.perf_counter(),
                     device="cpu")
    out, err = capsys.readouterr()
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    return rc, (json.loads(lines[-1]) if lines else None), err, out
