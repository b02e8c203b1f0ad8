"""What the benchmark loads: no JAX and no JAX package in a run, and
nothing of the port in the plain references."""
from __future__ import annotations

import json
import subprocess
import sys
import types

from conftest import ROOT, make_root

PROBE = r"""
import sys, time
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from benchmarks import harness
rc = harness.run({tiny!r}, {cell!r}, 2**31 + 5, 0.01, False, time.perf_counter(),
                 device="cpu")
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print("TOPS", __import__("json").dumps(tops))
sys.exit(rc)
"""


def _tops(out: str) -> list:
    line = [ln for ln in out.splitlines() if ln.startswith("TOPS ")][-1]
    return json.loads(line[5:])


def test_runs_load_no_jax(tmp_path):
    tiny = make_root(tmp_path)
    for cell in ("noaa_pass_card", "funcube_pass_card"):
        proc = subprocess.run([sys.executable, "-c",
                               PROBE.format(root=ROOT, tiny=tiny, cell=cell)],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-3000:]
        tops = _tops(proc.stdout)
        assert "directdemod_tpu_torch" in tops
        for bad in ("jax", "jaxlib", "flax", "directdemod_tpu"):
            assert bad not in tops, (cell, bad)


def test_references_load_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import benchmarks.reference.apt, benchmarks.reference.bpsk, "
            "benchmarks.synth.apt, benchmarks.synth.bpsk, benchmarks.counts; "
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    tops = json.loads(out.strip().splitlines()[-1])
    for bad in ("directdemod_tpu_torch", "directdemod_tpu", "jax"):
        assert bad not in tops


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmarks import harness
    monkeypatch.setitem(sys.modules, "directdemod_tpu_torch.fake",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("y"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "directdemod_tpu.fake", types.ModuleType("z"))
    assert harness.forbidden_modules() == ["directdemod_tpu"]
