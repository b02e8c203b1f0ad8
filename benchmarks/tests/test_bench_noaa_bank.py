"""The `noaa_apt_3sat` configuration's parts on the CPU at tiny sizes: the
published values it states, the synthesizer's three carriers, the plain
reference's independence from the port, the per-layer readers on a trace
from a program that lacks their spans and counters, the configuration's
comparison (`drivers/noaa_bank.py`) against planted faults and the
precision control, and the cell run whole through the harness."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, make_root, run_cell

from benchmarks.counts import PEAK_BYTES_S, PEAK_FP32_S, ddc_launch
from benchmarks.harness import load_module, resolve
from benchmarks.synth import apt_bank as synth

SEED = 2 ** 31 + 41
NAMES = ("noaa_bank.frontend_s", "noaa_bank.crude_sync_s", "noaa_bank.image_s",
         "noaa_bank.accurate_sync_s", "noaa_bank.accurate_batches",
         "noaa_bank.k1_roofline")
# the telemetry frame at 2 lines a wedge, so that a tiny pass holds wedges
TINY_TELEMETRY = {"wedge_lines": 2, "frame_lines": 32}


def _cfg(tiny=True):
    with open(os.path.join(BENCH, "configs", "noaa_apt_3sat.json")) as f:
        cfg = json.load(f)
    if tiny:
        cfg["telemetry"] = {**cfg["telemetry"], **TINY_TELEMETRY}
    return cfg


def _driver():
    return load_module(os.path.join(BENCH, "drivers", "noaa_bank.py"), "drv_noaa_bank")


def _reader(name):
    return load_module(os.path.join(BENCH, "layers", f"{name}.py"),
                       "r_" + name.replace(".", "_"))


def test_cell_resolves_by_name():
    spec = resolve(ROOT, "noaa_bank_3sat")
    cfg, traffic = spec["cfg"], spec["traffic"]
    assert cfg["name"] == "noaa_apt_3sat" and spec["cell"]["chips"] == 1
    assert os.path.basename(spec["driver"]) == "noaa_bank.py"
    assert cfg["reduced"] == []
    assert {m["name"] for m in spec["per_layer"]} == set(NAMES) | {"device.idle_pct"}
    # the published values: 2.048 Msps centred at 137.5 MHz, the three APT
    # downlinks, and noaa_apt's line, telemetry and front end
    with open(os.path.join(BENCH, "configs", "noaa_apt.json")) as f:
        one = json.load(f)
    for k in ("sample_rate", "word_rate", "words_per_line", "line_layout",
              "telemetry", "subcarrier_hz", "deviation_hz", "fm_bandwidth_hz",
              "frontend_taps", "precision"):
        assert cfg[k] == one[k], k
    assert cfg["centre_hz"] == 137_500_000
    assert [(c["frequency_hz"], c["offset_hz"]) for c in cfg["channels"]] == [
        (137_620_000, 120_000), (137_912_500, 412_500), (137_100_000, -400_000)]
    assert [c["amplitude"] for c in cfg["channels"]] == [0.45, 0.30, 0.15]
    assert set(cfg["limits"]) == set(one["limits"]) | {"channels_not_useful"}
    assert cfg["limits"]["channels_not_useful"] == 0
    assert set(cfg["limits_why"]) == set(cfg["limits"])
    assert traffic["channels"] == len(cfg["channels"]) == 3
    assert traffic["lines"] == 1200 and traffic["source"] == "card"


def test_synth_carries_each_channel_at_its_amplitude():
    """The capture's power at each channel's offset (60 kHz about it)
    stands to the others as the amplitudes' squares, and no byte clips."""
    cfg = _cfg()
    raw, planted = synth.pass_bytes(2, cfg, 0.05, "cpu", SEED)
    assert len(planted) == 3 and len({p[1] for p in planted}) == 3
    assert int(raw.min()) > 0 and int(raw.max()) < 255
    x = (raw[0::2].double() - 127.5) + 1j * (raw[1::2].double() - 127.5)
    spec = np.abs(np.fft.fft(x.numpy())) ** 2
    f = np.fft.fftfreq(len(spec), 1 / cfg["sample_rate"])
    power = [spec[np.abs(f - c["offset_hz"]) < 30_000].sum() for c in cfg["channels"]]
    share = np.asarray(power) / power[0]
    want = np.asarray([c["amplitude"] for c in cfg["channels"]]) ** 2 / 0.45 ** 2
    assert np.allclose(share, want, rtol=0.05)


def test_seeds_differ_by_channel_and_repeat():
    seeds = synth.channel_seeds(2 ** 40 + 3, 3)
    assert len(set(seeds)) == 3 and seeds == synth.channel_seeds(2 ** 40 + 3, 3)
    assert all(0 <= s < 2 ** 63 for s in seeds)


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import benchmarks.reference.apt_bank, benchmarks.synth.apt_bank; "
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    tops = json.loads(out.strip().splitlines()[-1])
    for bad in ("directdemod_tpu_torch", "directdemod_tpu", "jax"):
        assert bad not in tops


def _events(extra=()):
    from benchmarks.trace import Events
    return Events({"traceEvents": [
        {"ph": "X", "ts": 0, "dur": 1e6, "cat": "user_annotation", "name": "bench.decode"},
        {"ph": "X", "ts": 10, "dur": 500, "cat": "user_annotation",
         "name": "noaa.crude_sync"}, *extra]})


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_the_program(name, monkeypatch):
    """A program with no bank (a one-channel decode's stages and counters,
    no K1 in the trace): every reader returns None."""
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "session_counts", lambda: {"noaa.crude_sync.device_rows": 2})
    ev = _events([{"ph": "X", "ts": 20, "dur": 50, "cat": "kernel",
                   "name": "void at::native::vectorized_elementwise_kernel"}])
    reader = _reader(name)
    assert reader.read({"records": [{"stage_seconds": {}}], "events": ev}) is None
    assert reader.read({"records": [], "events": None}) is None
    monkeypatch.delattr(stages, "session_counts")
    assert reader.read({"records": [{"stage_seconds": {}}], "events": ev}) is None


def test_stage_readers_average_over_decodes():
    recs = {"records": [{"stage_seconds": {"fm_frontend": 0.01, "crude_sync": 0.1,
                                           "image": 1.0, "accurate_sync": 0.5}},
                        {"stage_seconds": {"fm_frontend": 0.03, "crude_sync": 0.3,
                                           "image": 2.0, "accurate_sync": 0.7}}],
            "events": None}
    for name, want in (("frontend_s", 0.02), ("crude_sync_s", 0.2), ("image_s", 1.5),
                       ("accurate_sync_s", 0.6)):
        assert _reader(f"noaa_bank.{name}").read(recs) == pytest.approx(want)


def test_batches_reader_and_k1_roofline_hand_count(monkeypatch):
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "session_counts",
                        lambda: {"noaa_bank.accurate_sync.batches": 226})
    n = 1_229_312_000
    b, ops = ddc_launch(2 * n, 3, -(-n // 34), 151)
    assert b == 2 * n + 3 * (4 * -(-n // 34) + 8)
    least = max(b / PEAK_BYTES_S, ops / PEAK_FP32_S)
    ev = _events([{"ph": "X", "ts": 100, "dur": 8000, "cat": "kernel",
                   "name": "ddc_fm_u8_kernel(Args)"},
                  {"ph": "X", "ts": 9000, "dur": 8000, "cat": "kernel",
                   "name": "ddc_fm_u8_kernel(Args)"}])
    ctx = {"records": [{"least_s": {"ddc_fm_u8_kernel": least}}] * 2, "events": ev}
    assert _reader("noaa_bank.accurate_batches").read(ctx) == 113
    assert _reader("noaa_bank.k1_roofline").read(ctx) == pytest.approx(
        100 * 2 * least / 16e-3)


def _bank_root(tmp_path):
    """The cell as a new tiny cell, `noaa_bank_tiny`, beside the
    benchmark's own: 24 lines, the telemetry frame at 2 lines a wedge, the
    six metrics listing it."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = {"name": "noaa_bank_tiny", "config": "noaa_apt_3sat_tiny",
            "traffic": "noaa_bank_tiny", "chips": 1,
            "why": "the noaa_bank_3sat cell at a tiny size"}
    per_layer = [{**m, "workloads": ["noaa_bank_tiny"]} for m in manifest["per_layer"]
                 if m["name"] in NAMES]
    with open(os.path.join(BENCH, "workloads", "noaa_bank_3sat.json")) as f:
        traffic = json.load(f)
    root = make_root(tmp_path, extra_cells=[(cell, {
        **traffic, "config": "noaa_apt_3sat_tiny", "lines": 24,
        "_per_layer": per_layer})])
    with open(os.path.join(root, "benchmarks", "configs", "noaa_apt_3sat_tiny.json"),
              "w") as f:
        json.dump({**_cfg(), "name": "noaa_apt_3sat_tiny"}, f)
    return root


def test_cell_runs_whole_and_correct(tmp_path, capsys):
    root = _bank_root(tmp_path)
    rc, res, err, out = run_cell(root, "noaa_bank_tiny", SEED, 0.01, capsys, trace=True)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    m = res["metrics"]
    for name in NAMES[:4]:
        assert m[name]["value"] > 0, name
    assert m["noaa_bank.accurate_batches"]["value"] >= 1
    assert "noaa_bank.k1_roofline" not in m          # no card, no kernel
    assert set(res["checks"]) == {"crude_sync_deficit", "image_share",
                                  "accurate_pos_gap", "accurate_quality_gap",
                                  "channels_not_useful"}
    assert res["checks"]["channels_not_useful"]["value"] == 0


def _one_late(monkeypatch):
    from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder
    orig = NoaaBankDecoder.get_crude_sync

    def late(self):
        out = orig(self)
        out[1] = [np.asarray(s) + 1 for s in out[1]]
        return out
    monkeypatch.setattr(NoaaBankDecoder, "get_crude_sync", late)


def _neighbour(monkeypatch):
    from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder
    orig = NoaaBankDecoder.__init__

    def at_neighbour(self, src, offsets, *a, **k):
        offsets = list(offsets)
        offsets[1] = offsets[0]
        orig(self, src, offsets, *a, **k)
    monkeypatch.setattr(NoaaBankDecoder, "__init__", at_neighbour)


@pytest.mark.parametrize("fault", [_one_late, _neighbour],
                         ids=["crude_syncs_one_late", "channel_at_neighbour_offset"])
def test_cell_catches_a_fault(fault, tmp_path, monkeypatch, capsys):
    root = _bank_root(tmp_path)
    fault(monkeypatch)
    rc, res, err, _ = run_cell(root, "noaa_bank_tiny", SEED, 0.01, capsys)
    assert rc == 0 and res["correct"] is False, err[-2000:]


def test_control_and_planted_faults_fail(tmp_path):
    """The TF32 control fails at least one limit; the planted readings
    (a channel's crude syncs one sample late, a channel decoded at its
    neighbour's offset) fail theirs."""
    torch.set_num_threads(2)
    drv = _driver()
    cfg = _cfg()
    with open(os.path.join(BENCH, "workloads", "noaa_bank_3sat.json")) as f:
        traffic = {**json.load(f), "lines": 24}
    st = drv.setup(cfg, traffic, SEED, torch.device("cpu"), str(tmp_path))
    lim = cfg["limits"]
    ctl = drv.control(st)
    assert any(ctl[k] > lim[k] for k in lim), ctl
    planted = drv.planted(st)
    assert planted["crude_sync_deficit.one_late"] > lim["crude_sync_deficit"]
    assert any(planted[f"{k}.neighbour"] > lim[k] for k in drv.NUMBERS), planted
