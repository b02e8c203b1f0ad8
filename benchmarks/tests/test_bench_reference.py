"""The plain references on tiny captures against the synthesizers' ground
truth, and the precision control against the reference (on the card)."""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH

from benchmarks.reference import apt as ref_apt
from benchmarks.reference import bpsk as ref_bpsk
from benchmarks.reference.apt import Precision
from benchmarks.synth import apt as synth_apt
from benchmarks.synth import bpsk as synth_bpsk


def _cfg(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def apt_pass():
    torch.set_num_threads(2)
    cfg = _cfg("noaa_apt")
    raw, lines = synth_apt.pass_bytes(24, cfg, 0.05, "cpu", 2 ** 31 + 11)
    return cfg, raw, lines


@pytest.fixture(scope="module")
def bpsk_pass():
    torch.set_num_threads(2)
    cfg = _cfg("funcube_bpsk")
    raw, starts = synth_bpsk.pass_bytes(
        11.0, cfg["sample_rate"], cfg["bit_rate"], cfg["sync_bits"], 1.0,
        cfg["frame_spacing_s"], cfg["amplitude"],
        cfg["offset_hz"] + cfg["carrier_error_hz"], 2.0, 8, "cpu", 2 ** 31 + 13)
    return cfg, raw, starts


def test_apt_reference_decodes_the_planted_pass(apt_pass):
    cfg, raw, lines = apt_pass
    out = ref_apt.decode(raw, cfg, "fp64")
    rate, fs = out["rate"], cfg["sample_rate"]
    assert rate == 60235 and out["useful"] == 1
    # every sync half a second from the last, but for a last sync B in the
    # recording's last half line: needle B correlates at ~0.75 with any
    # flat stretch, here telemetry A, and no true sync B follows within
    # the grouping distance to absorb it (the decoder does the same)
    for syncs in (out["sync_a"], out["sync_b"]):
        assert np.all(np.abs(np.diff(syncs)[:-1] - 0.5 * rate) < 5)
        assert syncs[-1] > 24 * 0.5 * rate
    # line i's sync train A starts at i / 2 s
    sa = np.asarray(out["sync_a"], np.float64)
    assert np.all(np.abs(sa - np.round(sa / (0.5 * rate)) * 0.5 * rate) < 20)
    img = out["image"]
    assert img.shape[1] == 2080 and img.shape[0] >= 22
    # the image words of channel A (86..994 of the KLM line)
    cors = [np.corrcoef(img[r, 100:980].astype(float), lines[r, 100:980])[0, 1]
            for r in range(img.shape[0])]
    assert np.median(cors) > 0.9
    acc = out["accurate"]
    assert len(acc[0]) >= 20 and np.all(np.abs(np.asarray(acc[1]) - 0.5 * fs) < 300)
    assert min(acc[2]) > 0.5


def test_apt_line_layout():
    """Each channel: 39 sync words, 47 of space, 909 image words, 45 of
    telemetry at one wedge's level (NOAA KLM User's Guide section 4.2)."""
    cfg = _cfg("noaa_apt")
    lines = synth_apt.picture(256, cfg, 2 ** 31 + 3)
    for h, sync in ((0, synth_apt.SYNCA), (1040, synth_apt.SYNCB)):
        assert np.all(lines[:, h:h + 39] == np.asarray(sync[:39]) * 233.0 + 11.0)
        assert np.all((lines[:, h + 39:h + 86] == 11.0) | (lines[:, h + 39:h + 86] == 244.0))
        assert np.all((lines[:, h + 86:h + 995] >= 30) & (lines[:, h + 86:h + 995] <= 220))
        tel = lines[:, h + 995:h + 1040]
        assert np.all(tel == tel[:, :1])
        # 16 wedges of 8 lines: the level changes at most every 8 lines
        steps = np.flatnonzero(np.diff(tel[:, 0]))
        assert np.all(np.diff(steps) % 8 == 0)
    # wedges 1-8 and the zero wedge appear in both channels
    for level in [255.0 * n / 8 for n in range(1, 9)] + [0.0]:
        assert np.any(lines[:, 1000] == level) and np.any(lines[:, 2040] == level)


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 7])
def test_apt_wedge_walk_fits_every_frame(seed):
    """The reference's calibration walk, fed the telemetry strips of a
    10-minute pass at their word levels, fits its calibration once a
    frame (9.4 frames: 8 or 9 whole ones) and maps the wedges back onto
    their words."""
    cfg = _cfg("noaa_apt")
    lines = synth_apt.picture(1200, cfg, seed)
    calib = ref_apt._Calib(0.0, 255.0)
    for j in range(1, lines.shape[0]):
        # before line j's syncs: line j - 1's telemetry B, line j's A
        calib.wedge(lines[j - 1, -40:].mean(), lines[j, 1000:1040].mean())
    assert calib.locks >= 8
    assert calib.slope == pytest.approx(1.0) and calib.intercept == pytest.approx(0.0, abs=1e-9)


def test_bpsk_reference_finds_the_planted_frames(bpsk_pass):
    cfg, raw, starts = bpsk_pass
    assert len(starts) == 2
    got = ref_bpsk.frame_syncs(raw, cfg, starts, Precision("fp64"))
    # the needle's centre behind the low-pass's delay: 28,149 + ~206
    assert np.all(np.abs(np.asarray(got) - starts - 28_355) <= 40)


def test_bpsk_reference_scan_from_the_start(bpsk_pass):
    """The scan from the decoder's initial state (no state of the port)
    over the reference's own filtered capture fires its minsync inside
    each planted frame and nowhere else."""
    cfg, raw, starts = bpsk_pass
    n = raw.shape[0] // 2
    h = ref_bpsk.lowpass_response(cfg)
    x = ref_bpsk.filtered(raw, cfg, 0, n, h, Precision("fp64")).numpy()
    f = [0.0] * 11
    f[7], f[9], f[10] = cfg["pll"]["agc_mean0"], 0.001, 1.0
    i = [0] * 23
    i[4] = -1
    a, m = ref_bpsk.scan(x, ref_bpsk.ScanState(f, i), cfg)
    assert len(a) == pytest.approx(n / (cfg["sample_rate"] / cfg["symbol_rate"]), abs=3)
    fired = np.asarray(a)[np.asarray(m)]
    span = 33 * cfg["sample_rate"] / cfg["bit_rate"]
    assert len(fired) > 0
    for s in starts:
        assert np.any((fired > s) & (fired < s + span + 2000))
    assert np.all(np.any([(fired > s) & (fired < s + span + 2000) for s in starts],
                         axis=0))


@pytest.mark.cuda
def test_apt_control_fails_on_the_card(cuda_device, apt_pass):
    """The TF32 control, in the program's place, reads above the limits."""
    cfg, raw, _ = apt_pass
    raw = raw.to(cuda_device)
    ctl = ref_apt.decode(raw, cfg, "tf32")
    crude = (ctl["sync_a"], ctl["sync_b"])
    fr = ref_apt.front(raw, cfg, "fp64")
    want = ref_apt.products(raw, cfg, fr, *crude)
    from benchmarks.harness import load_module
    drv = load_module(os.path.join(BENCH, "drivers", "noaa.py"), "drv_noaa")
    nums = drv.compare(ctl["image"], ctl["accurate"], crude, fr, want)
    assert any(nums[k] > cfg["limits"][k] for k in nums), nums


@pytest.mark.cuda
def test_bpsk_control_fails_on_the_card(cuda_device, bpsk_pass):
    cfg, raw, starts = bpsk_pass
    raw = raw.to(cuda_device)
    n = raw.shape[0] // 2
    h = ref_bpsk.lowpass_response(cfg)
    want = ref_bpsk.filtered(raw, cfg, 0, n, h, Precision("fp64"))
    ctl = ref_bpsk.filtered(raw, cfg, 0, n, h, Precision("tf32"))
    from benchmarks.harness import load_module
    drv = load_module(os.path.join(BENCH, "drivers", "funcube.py"), "drv_fc")
    f = [0.0] * 11
    f[7], f[9], f[10] = cfg["pll"]["agc_mean0"], 0.001, 1.0
    i = [0] * 23
    i[4] = -1
    st = ref_bpsk.ScanState(f, i)
    ra, rm = ref_bpsk.scan(want.cpu().numpy(), st, cfg, "fp64")
    ca, cm = ref_bpsk.scan(ctl.to(torch.complex128).cpu().numpy()[:2_000_000], st,
                           cfg, "tf32")
    nums = {"baseband_gap": drv.baseband_gap(ctl, want),
            "symbol_gap": drv.symbol_gap(ca, cm, ra[:len(ca)], rm[:len(cm)])}
    assert any(nums[k] > cfg["limits"][k] for k in nums), nums
