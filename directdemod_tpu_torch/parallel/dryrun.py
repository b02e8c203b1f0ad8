"""Dry run of the production sharded paths on a (time x channel) mesh.

Port of `directdemod_tpu/parallel/dryrun.py:1-155`. It drives the real
classes end to end so that a regression in any of them fails the run:

  * `ShardedDdcFm.process`        -- the wave-parallel fused DDC+FM with its
    `ppermute` halo over `time` (parallel/sharded.py), against the
    sequential `DdcFm.process`;
  * `MultiDdcFm(mesh=...)`        -- the channel-parallel front end over
    `channel` (models/multichannel.py), against the unsharded bank;
  * `sharded_find_sync_peaks`     -- needle-halo correlation and the
    gathered adaptive threshold (parallel/correlate.py), against the
    sequential sync search;
  * `symbol_scan_segments(mesh=)` -- the segment-parallel PLL scan over
    `time` (ops/pll.py), checked for owned-symbol coverage;
  * `sharded_zero_phase` + `sharded_envelope_blocked` -- the NOAA image
    stage's exact time-sharded filtfilt (parallel/iir.py) and blocked
    Hilbert envelope (parallel/am.py), against the sequential ops.

The mesh's shards name `devices` (a list), or `device` repeated: one card
or one CPU carries every shard, one after the other.
"""
from __future__ import annotations

import time as _time

import numpy as np
import torch

from .. import constants as K
from ..device import resolve
from ..io.sources import ArraySource
from ..models.frontend import DdcFm
from ..models.multichannel import MultiDdcFm
from ..ops import am as am_ops, correlate as corr_ops, design, iir as iir_ops
from ..ops import peaks as peaks_ops
from ..ops.pll import PskParams, symbol_scan_segments
from .am import sharded_envelope_blocked
from .correlate import sharded_find_sync_peaks
from .iir import sharded_zero_phase
from .mesh import make_mesh
from .sharded import ShardedDdcFm

FS = 2048000


def _capture(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    t = np.arange(n) / FS
    x = (np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 400 * t)))
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex64)


def dryrun(n_devices: int, chunk_len: int = 8192, device=None,
           devices=None) -> dict:
    """Run the checks on an `n_devices`-shard mesh: a 2-wide `channel` axis
    when n_devices is even (and > 1), `time` the rest. Returns the errors,
    the syncs, the owned PLL symbols and each sharded stage's seconds; a
    failed check raises AssertionError."""
    stage_s = {}

    class _stage:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            self.t0 = _time.perf_counter()

        def __exit__(self, *exc):
            stage_s[self.name] = round(_time.perf_counter() - self.t0, 3)

    devices = (list(devices)[:n_devices] if devices is not None
               else [resolve(device)] * n_devices)
    dev = torch.device(devices[0])
    channel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    time = n_devices // channel
    mesh = make_mesh(time=time, channel=channel, devices=devices)
    taps = design.blackmanharris(151)
    x = _capture(2 * time * chunk_len + chunk_len // 2)
    src = ArraySource(x, FS)

    # -- 1. sequence-parallel front end (ppermute halo over `time`)
    fe = DdcFm(FS, 30000, taps, 60000, fm=True)
    ref, _ = fe.process(src, block_size=chunk_len, device=dev)
    with _stage("frontend_sharded"):
        got, _ = ShardedDdcFm(fe, mesh).process(src, block_size=chunk_len)
    err_fe = float(np.max(np.abs(got - ref)))
    assert got.shape == ref.shape and err_fe < 1e-3, err_fe

    # -- 2. channel-parallel front end (a bank a `channel` shard)
    freqs = tuple(30000.0 - 7000.0 * i for i in range(2 * channel))
    multi = MultiDdcFm(FS, freqs, taps, 60000, fm=True, mesh=mesh)
    with _stage("multichannel"):
        got_mc, _ = multi.process(src, block_size=chunk_len)
    ref_mc, _ = MultiDdcFm(FS, freqs, taps, 60000, fm=True).process(
        src, block_size=chunk_len, device=dev)
    err_mc = float(np.max(np.abs(got_mc - ref_mc)))
    assert got_mc.shape == ref_mc.shape and err_mc < 1e-3, err_mc

    # -- 3. sharded sync search (needle halos + all_gather threshold)
    rate = 4160 * 4
    needle = corr_ops.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True)
    env = np.full(8 * rate, 0.2, np.float32)
    rng = np.random.default_rng(1)
    env += 0.01 * rng.standard_normal(len(env)).astype(np.float32)
    pulses = np.arange(rate // 2, len(env) - len(needle), rate // 2)
    for s in pulses:
        env[s:s + len(needle)] += np.asarray(needle, np.float32)
    seq = peaks_ops.find_sync_peaks(
        corr_ops.norm_correlate(torch.from_numpy(env).to(dev),
                                torch.as_tensor(needle, dtype=torch.float32,
                                                device=dev)),
        rate, len(needle), K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
    with _stage("sync_search_sharded"):
        got_sync = sharded_find_sync_peaks(
            mesh, env, np.asarray(needle), rate,
            K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
    assert len(got_sync) == len(seq) and len(seq) > 0, (got_sync, seq)

    # -- 4. segment-parallel PLL scan over `time`
    p = PskParams(fs=FS, sym_rate=12000, qpsk=False, agc_mean0=180.0,
                  agc_gain_cap=20.0, costas_bw=0.05235833333 * 6,
                  minsync_thresh=120.0)
    sync = np.zeros(33, np.float32)
    xs = torch.from_numpy(x[:time * chunk_len]).to(dev)
    with _stage("pll_segments_sharded"):
        _, _, owned = symbol_scan_segments(p, xs, sync, sync, n_segments=time,
                                           warmup_symbols=8, mesh=mesh)
    n_owned = int(owned.sum())
    assert n_owned > 0

    # -- 5. sharded NOAA image stage: exact filtfilt + blocked envelope
    bp = iir_ops.IirFilter.design_butter(60000, 400, 4400, order=6,
                                         kind="bandpass")
    audio = np.asarray(ref, np.float32)
    ref_bp = bp.zero_phase(torch.from_numpy(audio).to(dev)).cpu().numpy()
    with _stage("image_filtfilt_sharded"):
        got_bp = sharded_zero_phase(mesh, bp, audio)
    scale = float(np.max(np.abs(ref_bp))) or 1.0
    err_bp = float(np.max(np.abs(got_bp - ref_bp))) / scale
    assert err_bp < 1e-5, err_bp
    blk = len(audio) // (2 * time)
    ref_env = am_ops.envelope_blocked(torch.from_numpy(audio).to(dev),
                                      blk).cpu().numpy()
    with _stage("image_envelope_sharded"):
        got_env = sharded_envelope_blocked(mesh, audio, blk)
    err_env = float(np.max(np.abs(got_env - ref_env)))
    assert err_env < 1e-4, err_env

    out = {
        "mesh": dict(mesh.shape),
        "image_stage_err": max(err_bp, err_env),
        "frontend_err": err_fe,
        "multichannel_err": err_mc,
        "syncs": [int(v) for v in got_sync],
        "pll_owned_symbols": n_owned,
        "finite": bool(np.all(np.isfinite(got))),
        # wall-clock seconds of each sharded stage, first use included
        "stage_seconds": stage_s,
    }
    assert out["finite"], "dry run produced non-finite output"
    return out
