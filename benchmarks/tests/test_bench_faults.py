"""A run whose timed path is broken underneath comes out not correct: the
rest of a run (synthesis, window, check) as the harness drives it, on the
CPU at tiny sizes, the look for a card skipped. One case a fault each cell
can have: a step that returns its state unchanged, half of the work left
out, an answer altered where it is produced. (The cells run on one card:
there is no exchange between cards to leave out.)"""
from __future__ import annotations

import json
import os

import pytest

from conftest import NOAA_SEED, make_root, run_cell


def _noaa_half_audio(monkeypatch):
    from directdemod_tpu_torch.ops import ddc
    orig = ddc.ddc_fm_u8

    def half(*a, **k):
        audio, c = orig(*a, **k)
        audio = audio.clone()
        audio[..., audio.shape[-1] // 2:] = 0.0
        return audio, c
    monkeypatch.setattr(ddc, "ddc_fm_u8", half)


def _noaa_wedge_step_unchanged(monkeypatch):
    from directdemod_tpu_torch.models import apt
    monkeypatch.setattr(apt._Calib, "step_wedge", lambda self, a, b: None)


def _noaa_sync_altered(monkeypatch):
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    orig = NoaaDecoder.get_accurate_sync

    def altered(self, *a, **k):
        out = [list(c) for c in orig(self, *a, **k)]
        out[0][len(out[0]) // 2] += 100
        return out
    monkeypatch.setattr(NoaaDecoder, "get_accurate_sync", altered)


def _noaa_image_altered(monkeypatch):
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    orig = NoaaDecoder.get_image

    def altered(self):
        img = orig(self).copy()
        img[img.shape[0] // 2] ^= 1
        return img
    monkeypatch.setattr(NoaaDecoder, "get_image", altered)


@pytest.mark.parametrize("fault", [_noaa_half_audio, _noaa_wedge_step_unchanged,
                                   _noaa_sync_altered, _noaa_image_altered],
                         ids=["half_the_audio", "wedge_step_unchanged",
                              "accurate_sync_altered", "image_row_altered"])
def test_noaa_fault_is_caught(fault, tmp_path, monkeypatch, capsys):
    root = make_root(tmp_path)
    fault(monkeypatch)
    rc, res, err, _ = run_cell(root, "noaa_pass_card", NOAA_SEED, 0.01, capsys)
    assert rc == 0 and res["correct"] is False, err[-2000:]


def _fc_blocks(tmp_path, monkeypatch, block=4_000_000):
    """The tiny Funcube cell through the decoder's block loop (blocks of
    `block` samples, so the scan state crosses block edges as in a
    10-minute pass): the decoder's block size and whole-capture cap, and
    the configuration's block size, set to match."""
    from directdemod_tpu_torch.models import funcube, psk_sync
    monkeypatch.setattr(funcube, "PROC_CHUNKSIZE", block)
    monkeypatch.setattr(psk_sync, "_CAPTURE_SEG_MAX", 0)
    root = make_root(tmp_path)
    path = os.path.join(root, "benchmarks", "configs", "funcube_bpsk.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["block_samples"] = block
    os.remove(path)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return root


def _fc_state_unchanged(monkeypatch):
    from directdemod_tpu_torch.ops import pll
    orig = pll.symbol_scan

    def stuck(p, x, state, sync, sync1):
        _, syms = orig(p, x, {k: v.clone() for k, v in state.items()}, sync, sync1)
        return state, syms
    monkeypatch.setattr(pll, "symbol_scan", stuck)


def _fc_half_block(monkeypatch):
    from directdemod_tpu_torch.ops import iir
    orig = iir.IirFilter.apply

    def half(self, x, z):
        y, z2 = orig(self, x, z)
        if y.is_complex():
            y = y.clone()
            y[y.shape[0] // 2:] = 0
        return y, z2
    monkeypatch.setattr(iir.IirFilter, "apply", half)


def _fc_sync_altered(monkeypatch):
    from directdemod_tpu_torch.models.psk_sync import PskSyncDetector
    orig = PskSyncDetector.get_syncs

    def altered(self):
        return [s + 100.0 for s in orig(self)]
    monkeypatch.setattr(PskSyncDetector, "get_syncs", altered)


@pytest.mark.parametrize("fault", [_fc_state_unchanged, _fc_half_block,
                                   _fc_sync_altered],
                         ids=["scan_state_unchanged", "half_of_each_block",
                              "sync_altered"])
def test_funcube_fault_is_caught(fault, tmp_path, monkeypatch, capsys):
    root = _fc_blocks(tmp_path, monkeypatch)
    fault(monkeypatch)
    rc, res, err, _ = run_cell(root, "funcube_pass_card", 2 ** 31 + 23, 0.01, capsys)
    assert rc == 0 and res["correct"] is False, err[-2000:]


def test_funcube_block_loop_sound(tmp_path, monkeypatch, capsys):
    """The same tiny block-loop run without a fault comes out correct."""
    root = _fc_blocks(tmp_path, monkeypatch)
    rc, res, err, _ = run_cell(root, "funcube_pass_card", 2 ** 31 + 23, 0.01, capsys)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_noaa_sound(tmp_path, capsys):
    """The tiny NOAA run without a fault comes out correct, its reference
    having fitted the calibration from the wedges."""
    root = make_root(tmp_path)
    rc, res, err, out = run_cell(root, "noaa_pass_card", NOAA_SEED, 0.01, capsys)
    assert rc == 0 and res["correct"] is True, err[-2000:]
    assert "reference wedge fits a decode: [1]" in out
