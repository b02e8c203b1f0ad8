"""The `aprs_afsk1200` configuration's parts on the CPU at tiny sizes: the
frames the synthesizer plants (FCS, stuffing, NRZI), the plain reference
against them, the correctness comparison of `drivers/aprs.py` against
planted faults and the precision control, K2's count, the per-layer
readers on a trace from a program that lacks their spans and counters, and
the cell run whole through the harness."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, make_root, run_cell

from benchmarks.counts import PEAK_BYTES_S, PEAK_FP32_S
from benchmarks.harness import load_module, resolve
from benchmarks.reference import afsk as ref
from benchmarks.synth import afsk as synth

SEED = 2 ** 31 + 91
NAMES = ("afsk.bit_sync_s", "afsk.framing_s", "afsk.walk_s", "afsk.frames_host_s",
         "afsk.crc_checks", "k2_roofline")


def _cfg():
    with open(os.path.join(BENCH, "configs", "aprs_afsk1200.json")) as f:
        return json.load(f)


def _traffic(**change):
    with open(os.path.join(BENCH, "workloads", "aprs_pass_card.json")) as f:
        t = json.load(f)
    t.update(info_bytes=[20, 40], preamble_flags=[24, 26], first_gap_s=0.2)
    t.update(change)
    return t


def _driver():
    return load_module(os.path.join(BENCH, "drivers", "aprs.py"), "drv_aprs")


def _reader(name):
    return load_module(os.path.join(BENCH, "layers", f"{name}.py"),
                       "r_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def aprs_pass():
    torch.set_num_threads(2)
    cfg = _cfg()
    raw, frames = synth.pass_bytes(5.0, cfg, _traffic(), "cpu", SEED)
    return cfg, raw, frames


def test_cell_resolves_by_name():
    spec = resolve(ROOT, "aprs_pass_card")
    assert spec["cfg"]["name"] == "aprs_afsk1200" and spec["cell"]["chips"] == 1
    assert os.path.basename(spec["driver"]) == "aprs.py"
    assert spec["cfg"]["reduced"] == []
    names = [m["name"] for m in spec["per_layer"]]
    assert set(NAMES) | {"device.idle_pct"} == set(names)
    assert spec["traffic"]["seconds"] * spec["cfg"]["sample_rate"] == 1_228_800_000
    # the published values the decoder takes
    cfg = spec["cfg"]
    assert cfg["sample_rate"] // cfg["bw"] == cfg["stride"] == 92
    assert int(cfg["bw"] // cfg["baud"] * 0.65) == cfg["lookahead"] == 11


def test_fcs_check_value():
    """CRC-16/X.25's catalogued check value, 0x906E over "123456789", from
    the synthesizer's byte loop and the reference's bit loop."""
    data = b"123456789"
    assert synth.fcs(data) == 0x906E
    assert ref.fcs([(b >> i) & 1 for b in data for i in range(8)]) == 0x906E


def test_stuffing_breaks_every_run_of_five():
    assert synth.stuff([1] * 12) == [1] * 5 + [0] + [1] * 5 + [0] + [1] * 2
    assert synth.stuff([1, 1, 1, 1, 0, 1]) == [1, 1, 1, 1, 0, 1]


def test_synth_plants_valid_frames():
    """The planned levels, read back baud by baud through the reference's
    bit layer (NRZI, flags, unstuffing, the FCS, the AX.25 parse), give
    every planted frame in order; no frame body holds six 1s in a row."""
    cfg = _cfg()
    starts, levels, lengths, _, frames = synth.plan(30.0, cfg, _traffic(), SEED)
    assert len(frames) == len(starts) == len(lengths) >= 10
    assert np.all(np.diff(starts) > 0)
    got, counts = ref.frames([float(v) for v in levels])
    assert [tuple(f) for f in got] == [f.key() for f in frames]
    assert counts["flags"] >= 24 * len(frames)
    for f in frames:
        assert f.destination[:-1].rstrip() in cfg["ax25"]["tocalls"]
        assert f.path == "RS0ISS" + chr(0xE1 >> 1)           # RS0ISS*, the last
        assert 20 <= len(f.info) <= 40 and f.info.isprintable()
        assert f.info[0] in "!:>"
    bits = [(b >> i) & 1 for b in b"\xff\xff" for i in range(8)]
    assert "111111" not in "".join(map(str, synth.stuff(bits)))


def test_synth_share_on_air():
    """About 70 % of a 10-minute pass's bauds on air, ~360 frames."""
    cfg = _cfg()
    with open(os.path.join(BENCH, "workloads", "aprs_pass_card.json")) as f:
        t = json.load(f)
    _, _, lengths, _, frames = synth.plan(600.0, cfg, t, SEED)
    assert 0.6 < sum(lengths) / (600 * cfg["baud"]) < 0.8
    assert 300 < len(frames) < 420


def test_reference_decodes_the_planted_frames(aprs_pass):
    cfg, raw, frames = aprs_pass
    want = ref.decode(raw, cfg)
    assert [tuple(f) for f in want["frames"]] == [f.key() for f in frames]
    assert want["counts"]["frames"] == len(frames) >= 3
    assert len(want["edge"]) == ref.audio_length(raw, cfg)
    # a stretch of the audio computed from the bytes around it alone
    m0, m1 = 20_000, 60_000
    part = ref.edges(raw, cfg, m0, m1)
    np.testing.assert_allclose(part["edge"], want["edge"][m0:m1], rtol=0, atol=1e-12)
    np.testing.assert_allclose(part["bf"], want["bf"][m0:m1 + 64], rtol=1e-9,
                               atol=1e-9 * np.abs(want["bf"]).max())


def test_reference_loads_nothing_of_the_port():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import benchmarks.reference.afsk, benchmarks.synth.afsk, "
            "benchmarks.counts_k2; "
            "import json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    tops = json.loads(out.strip().splitlines()[-1])
    for bad in ("directdemod_tpu_torch", "directdemod_tpu", "jax"):
        assert bad not in tops


def _state(aprs_pass, m0=0, m1=None):
    cfg, raw, frames = aprs_pass
    M = ref.audio_length(raw, cfg)
    return {"cfg": cfg, "raw": raw, "frames": frames, "m0": m0,
            "m1": M if m1 is None else m1}


def test_planted_faults_and_control_fail(aprs_pass):
    """An info byte altered, a frame dropped and the peaks one baud late,
    each put in the program's place, fail a number; so does the reference
    at TF32 (its edge strength)."""
    drv = _driver()
    st = _state(aprs_pass)
    lim = st["cfg"]["limits"]
    got = drv.planted(st)
    for fault in ("info_byte_altered", "frame_dropped", "one_baud_late"):
        nums = {k.split(".")[0]: v for k, v in got.items() if k.endswith(fault)}
        assert any(v > lim[k] for k, v in nums.items()), (fault, nums)
    ctl = drv.control(st)
    assert ctl["edge_gap"] > lim["edge_gap"], ctl
    # the reference in the program's place passes
    want = drv.reference(st)
    ok = drv.window_numbers(st, want["edge"], want["peaks"], want["frames"], want)
    assert ok == {"edge_gap": 0.0, "peak_gap": 0.0, "ref_frames_gap": 0.0}
    keys = [f.key() for f in st["frames"]]
    assert drv.frame_numbers(keys, st["frames"]) == {"frames_missed": 0.0,
                                                     "extra_frames": 0.0}


def test_frame_numbers_in_order(aprs_pass):
    drv = _driver()
    frames = aprs_pass[2]
    keys = [f.key() for f in frames]
    swapped = [keys[1], keys[0]] + keys[2:]
    got = drv.frame_numbers(swapped, frames)
    assert got == {"frames_missed": 1 / len(keys), "extra_frames": 1.0}
    assert drv.frame_numbers(keys + [keys[0]], frames)["extra_frames"] == 1.0


def test_window_leaves_out_frames_across_its_ends(aprs_pass):
    """A window cut through a frame: the reference cannot decode it, and
    neither side counts it."""
    drv = _driver()
    cfg, _, frames = aprs_pass
    j = ref.rates(cfg)[0]
    cut = (frames[1].first_sample + frames[1].last_sample) // (2 * j)
    st = _state(aprs_pass, m0=cut)
    want = drv.reference(st)
    inside, across = drv._window_keys(st)
    assert frames[1].key() in across and frames[1].key() not in inside
    assert all(f.key() in inside for f in frames[2:]
               if f.last_sample // j < st["m1"] - 11 - int(drv.EDGE_S * ref.rates(cfg)[1]))
    keys = [f.key() for f in frames]
    nums = drv.window_numbers(st, want["edge"], want["peaks"], keys, want)
    assert nums["ref_frames_gap"] == 0.0


def test_counts_k2_hand_count():
    from benchmarks import counts_k2
    assert counts_k2.k2_walk(1000, 10) == (12_210, 6_000)
    assert counts_k2.k2_least_seconds(1000, 10) == pytest.approx(
        max(12_210 / PEAK_BYTES_S, 6_000 / PEAK_FP32_S))
    assert counts_k2.KERNELS == ("k2_speculative_walks", "k2_stitch", "k2_gather")


def _events(extra=()):
    from benchmarks.trace import Events
    return Events({"traceEvents": [
        {"ph": "X", "ts": 0, "dur": 1e6, "cat": "user_annotation", "name": "bench.decode"},
        {"ph": "X", "ts": 10, "dur": 500, "cat": "user_annotation", "name": "afsk.bit_sync"},
        *extra]})


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_the_program_counters(name, monkeypatch):
    """A program with no such spans or counters, and PyTorch's own
    `gather` kernel in the trace: every reader returns None."""
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "session_counts", lambda: {"psk.pass2.windows": 3})
    ev = _events([{"ph": "X", "ts": 20, "dur": 50, "cat": "kernel",
                   "name": "void at::native::_scatter_gather_elementwise_kernel"}])
    reader = _reader(name)
    assert reader.read({"records": [{"stage_seconds": {}}], "events": ev}) is None
    assert reader.read({"records": [], "events": None}) is None
    monkeypatch.delattr(stages, "session_counts")
    assert reader.read({"records": [{"stage_seconds": {}}], "events": ev}) is None


def test_k2_roofline_reader_hand_count(monkeypatch):
    from directdemod_tpu_torch.models import stages
    monkeypatch.setattr(stages, "session_counts", lambda: {
        "afsk.bit_sync.samples": 2_000_000, "afsk.bit_sync.events": 100_000})
    ev = _events([
        {"ph": "X", "ts": 100, "dur": 800, "cat": "kernel",
         "name": "(anonymous namespace)::k2_speculative_walks(Args)"},
        {"ph": "X", "ts": 1000, "dur": 150, "cat": "kernel",
         "name": "(anonymous namespace)::k2_stitch(Args)"},
        {"ph": "X", "ts": 1200, "dur": 50, "cat": "kernel",
         "name": "(anonymous namespace)::k2_gather(Args)"},
        {"ph": "X", "ts": 2000, "dur": 900, "cat": "kernel",
         "name": "void at::native::_scatter_gather_elementwise_kernel"}])
    least = (12 * 2_000_000 + 21 * 100_000) / PEAK_BYTES_S
    got = _reader("k2_roofline").read({"records": [{}, {}], "events": ev})
    assert got == pytest.approx(100 * least / 1e-3)


def test_span_readers_divide_by_decodes():
    ev = _events([{"ph": "X", "ts": 100, "dur": 300, "cat": "user_annotation",
                   "name": "afsk.bit_sync.walk"},
                  {"ph": "X", "ts": 600, "dur": 200, "cat": "user_annotation",
                   "name": "afsk.framing.frames"}])
    ctx = {"records": [{}, {}], "events": ev}
    assert _reader("afsk.walk_s").read(ctx) == pytest.approx(150e-6)
    assert _reader("afsk.frames_host_s").read(ctx) == pytest.approx(100e-6)
    recs = {"records": [{"stage_seconds": {"bit_sync": 0.2, "framing": 0.5}},
                        {"stage_seconds": {"bit_sync": 0.4, "framing": 0.7}}]}
    assert _reader("afsk.bit_sync_s").read(recs) == pytest.approx(0.3)
    assert _reader("afsk.framing_s").read(recs) == pytest.approx(0.6)


def _aprs_root(tmp_path, seconds=5.0):
    """The cell as a new tiny cell, `aprs_tiny`, beside the benchmark's own:
    a 5-s pass of short frames, the six metrics listing it."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = {"name": "aprs_tiny", "config": "aprs_afsk1200", "traffic": "aprs_tiny",
            "chips": 1, "why": "the aprs_pass_card cell at a tiny size"}
    per_layer = [{**m, "workloads": ["aprs_tiny"]} for m in manifest["per_layer"]
                 if m["name"] in NAMES]
    return make_root(tmp_path, extra_cells=[(cell, {**_traffic(seconds=seconds),
                                                    "_per_layer": per_layer})])


def test_cell_runs_whole_and_correct(tmp_path, capsys):
    root = _aprs_root(tmp_path)
    rc, res, err, out = run_cell(root, "aprs_tiny", SEED, 0.01, capsys, trace=True)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    m = res["metrics"]
    for name in NAMES[:5]:
        assert m[name]["value"] > 0, name
    assert m["afsk.crc_checks"]["value"] >= 3
    assert "k2_roofline" not in m          # no card, no kernel
    assert set(res["checks"]) == {"edge_gap", "peak_gap", "frames_missed",
                                  "extra_frames", "ref_frames_gap"}
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())
    assert "afsk.framing.flags" in out


def test_cell_catches_a_frame_altered(tmp_path, monkeypatch, capsys):
    root = _aprs_root(tmp_path)
    from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
    orig = Afsk1200Decoder.parse_ax25

    def parse(msg_bits):
        f = orig(msg_bits)
        f.info = f.info[:-1] + "#"
        return f
    monkeypatch.setattr(Afsk1200Decoder, "parse_ax25", staticmethod(parse))
    rc, res, err, _ = run_cell(root, "aprs_tiny", SEED, 0.01, capsys)
    assert rc == 0 and res["correct"] is False, err[-2000:]
    assert res["checks"]["frames_missed"]["value"] > res["checks"]["frames_missed"]["limit"]
