#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's decode paths, NOAA APT, AFSK1200/APRS, Funcube BPSK,
Meteor-M2 QPSK and FM, the chainable Stream API, the one-pass multichannel
front end and the device mesh, in one process and over two, on the card
and fails (non-zero exit, no result line) on any error. Phases, in order:

1. check that a CUDA device exists and print its name and power limit;
2. build the CUDA kernels K1 (`csrc/ddc_fm_u8.cu`), K4
   (`csrc/ddc_fm_c64.cu`), K2 (`csrc/lookahead_walk.cu`) and K3
   (`csrc/symbol_scan.cu`) from the checkout, all compilers at once;
3. hold K1 against its plain PyTorch version and an fp64 oracle at the
   NOAA path's block shape (J=34, K=151, one 20,000,000-sample block plus
   its history) and time both, and the cuDNN convolution of the same
   windows, with CUDA events;
4. synthesize a 10-minute NOAA pass (1,200 APT lines, 2.46 GB of uint8 IQ)
   on the card and decode it from a DeviceRawSource with NoaaDecoder, cold
   and then warm, checking usefulness, sync spacing, image size and
   content, and that K1 ran on that path; then hold K1 against its plain
   version at the shape that decode gave it;
5. run the command-line interface on a 30-second NOAA IQ.wav;
6. hold K1 against its plain version and the fp64 oracle at the AFSK
   path's block shape (J=92), as phase 3 does;
7. hold K2 against its plain version, event for event, on a stress input
   at delta 0 and delta 0.1, and time both;
8. synthesize a 10-minute APRS capture (1,228,800,000 samples, 2.46 GB of
   uint8 IQ, about 1,040 frames) on the card and decode it from a
   DeviceRawSource with Afsk1200Decoder, cold and then warm, checking that
   every planted frame comes back CRC-valid with its payload and that K1
   and K2 ran on that path; then hold K2 against its plain version on the
   first 2^21 samples of that decode's own edge strength and on all of it
   (13.36 M samples), print its chunks and the stitch's steps, and time it
   at several chunk lengths and as one walker (the chain bound);
9. run the command-line interface on a 30-second APRS IQ.wav;
10. hold K3 against its plain version on 12,000,000-sample BPSK and QPSK
    streams, sequential and with 8 segments: symbol indices, minsync flags
    and needle choices equal, the largest phase difference printed; time
    K3 with CUDA events (ns a symbol), and for the sequential scans read
    each stage warp's clocks from K3's measurement build;
11. synthesize a 10-minute Funcube capture (1,228,800,000 samples, 2.46 GB,
    121 frames) on the card and decode it from a DeviceRawSource with
    FuncubeDecoder, sequential, cold and then warm (the block loop, 62 K3
    launches with the scan state carried), checking that every planted
    frame after the first comes back at the synthesizer's sync delay and
    that K3 ran; then the first 60 s with 32 segments (the whole-capture
    path, one K3 launch) against the sequential decode of the same 60 s;
12. synthesize a 2-minute Meteor-M2 capture (8.64 M symbols, 1,091
    frames) and decode it sequentially, cold and warm (>= 95 % of the
    planted frames, K3 ran), then with 32 segments;
13. run the command-line interface on 30-second IQ.wav files:
    `-d funcube --freqshift` and `-d meteor --segments=8`;
14. hold K4 against its plain version and the fp64 oracle on a
    20,000,000-sample complex64 block at J=34 and J=68 (timed with the
    cuDNN convolution of the same windows), at a ragged out_len, with
    three channels (each equal to its one-channel launch bit for bit) and
    at J=409, with K1 at J=409 beside it;
15. synthesize a 10-minute complex64 FM capture (1,228,800,000 samples,
    9.83 GB in host memory) and decode it with FmDecoder from an
    ArraySource, cold and then warm: the audio must correlate with the
    modulating audio at >= 0.99, and K4 must run once a block (62);
16. tutorial 3's chain through Stream.run and Stream.run_fused and
    tutorial 2's chain on a 2-minute complex64 FM capture, a checkpoint
    after block 3 resumed in a fresh Pipeline (bit for bit), and a
    three-channel MultiDdcFm on the complex blocks (one K4 launch a block)
    against the one-channel front ends;
17. synthesize a 10-minute uint8 capture holding NOAA-15, -18 and -19 and
    run MultiDdcFm over it from a DeviceRawSource, cold and then warm: one
    K1 launch a block for the three channels, each equal bit for bit to
    the one-channel front end at its offset, timed against three
    one-channel runs;
18-24. the mesh (`directdemod_tpu_torch.parallel`), every shard naming
    this card: (a) ShardedDdcFm over phase 4's capture on 4 `time` shards,
    every output bit for bit DdcFm.process's at the same blocks, and one
    sharded K1 launch (a block with its halo as the head) against its plain
    version and the fp64 oracle, timed; (b) Stream.run_sharded against
    run_fused on phase 16's capture (K4), bit for bit; (c) NoaaDecoder with
    a 4-shard mesh on phase 4's capture, cold and warm, against the
    unsharded decode (crude syncs equal, >= 99 % of pixels, accurate syncs
    within a sample); (d) MultiDdcFm on a 1 x 3 `channel` mesh over phase
    17's capture, bit for bit the unsharded bank; (e) Funcube (phase 11's
    first 64 s) and Meteor (phase 12's capture) with 32 segments on a
    4-shard mesh against the same decodes without one: syncs equal, K3's
    symbols bit for bit; (f) `parallel.dryrun(4)`; then the NOAA CLI with
    --map, with --map --tle=tle/noaa18_synthetic.txt (no pyorbital here:
    the error is logged, the image written, no map) and with --mesh=2,
    which exits non-zero with the mesh's device-count message;
25. the mesh over two processes (`parallel.distributed`, gloo on
    localhost), started with `subprocess` (`chip_smoke.py --worker ...`),
    each owning two `time` shards that name this card: (g) ShardedDdcFm
    over phase 4's bytes written to a .dat file, each rank opening it as
    IQDat and reading its own blocks (K1), and (h) over phase 19's capture
    (K4), every output on every rank bit for bit the one-process mesh's;
    (i) NoaaDecoder(mesh=) cold and warm, rank 0 against phase 20's
    decode (crude syncs equal, >= 99.9 % of pixels and none off by more
    than 1, accurate syncs within a sample); (j) Stream.run_sharded
    (tutorial 3's chain) over phase 19's capture, every output on every
    rank bit for bit phase 19's one-process run_sharded (K4); each rank's
    launches and wall against the one-process mesh over the same files. A
    rank that fails or outlives its time fails the run;
26. the peak variants (`ops.peaks_extra`) on the card, on two seeded tones:
    (A) 2^20 samples, 64 a period, white noise of sigma 0.01; (B) 2^18
    clean samples, 2,048 a period, whose 65,536-sample half-periods of the
    32x interpolated walk cross K2's chunks without a fire. peaks_fft (one
    K2 launch at lookahead 500 over 2^25 and 2^23 interpolated samples)
    against the tones' analytic extrema; K2 against its plain version on
    the first 2^22 samples of each walk; the whole walk timed with its
    forward-window extrema, chunks, stitch steps and one walker; then
    peaks_parabola, peaks_sine, peaks_sine_locked and peaks_spline on (A),
    and on its first 2^16 samples against the same functions on the CPU;
27. print the kernel table as one JSON line (time, plain time, bound and
    library-call time, launches on each path, the mesh paths among them),
    then the result line {"ok": true, "device": {...}} last.

Phase 4 also prints the warm decode's `NoaaDecoder.profiler.report()`.

Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

FS = 2_048_000
WORD_RATE = 4160.0
OFFSET_HZ = 30_000.0
DEV_HZ = 17_000.0
# fp32 kernel against the fp64 oracle (the JAX suite's bar for the u8
# kernel), and kernel against plain fp32: wrapped phase differences, whose
# rare outliers sit where |c| is tiny and the discriminator amplifies
# rounding (the JAX suite's distributional bars)
ORACLE_TOL = 5e-4
PLAIN_P999_TOL = 1e-4
PLAIN_MAX_TOL = 2e-2

# APT sync trains (40 words each, before channel A / channel B)
SYNCA = (0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0,
         1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
SYNCB = (0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1,
         1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0)


def apt_line_words(image_a_row, image_b_row):
    """One 2080-word luminance line: [syncA(40) | A content(1000) |
    syncB(40) | B content(1000)]."""
    line = np.empty(2080)
    line[0:40] = np.asarray(SYNCA) * 233.0 + 11.0
    line[40:1040] = np.resize(image_a_row, 1000)
    line[1040:1080] = np.asarray(SYNCB) * 233.0 + 11.0
    line[1080:2080] = np.resize(image_b_row, 1000)
    return line


def synth_pass_bytes(n_lines: int, device, seed: int = 0,
                     chunk: int = 1 << 25) -> tuple[torch.Tensor, np.ndarray]:
    """APT capture of `n_lines` lines (+0.25 s) as interleaved uint8 IQ on
    `device`: the subcarrier AM of the line words, FM onto a 30 kHz offset
    with the phase integral carried in fp64 from chunk to chunk, complex
    noise of 0.05 per component, quantized like an 8-bit SDR. Returns
    (bytes, ground-truth word lines)."""
    lines = np.stack([apt_line_words(np.linspace(30, 220, 1000) + 10 * (i % 3),
                                     np.linspace(220, 30, 1000))
                      for i in range(n_lines)])
    words = torch.as_tensor(lines.reshape(-1), dtype=torch.float64,
                            device=device)
    n = int((n_lines * 0.5 + 0.25) * FS)
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phase0 = torch.zeros((), dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.float64, device=device) / FS
        widx = torch.clamp((t * WORD_RATE).long(), max=words.shape[0] - 1)
        env = 0.05 + 0.9 * words[widx] / 255.0
        baseband = env * torch.cos(2 * np.pi * 2400.0 * t)
        dphi = 2 * np.pi * (OFFSET_HZ / FS) + 2 * np.pi * DEV_HZ * baseband / FS
        phase = phase0 + torch.cumsum(dphi, 0)
        phase0 = torch.remainder(phase[-1], 2 * np.pi)
        for k, part in enumerate((torch.cos(phase), torch.sin(phase))):
            noisy = part + 0.05 * torch.randn(e - s, dtype=torch.float64,
                                              device=device, generator=gen)
            out[2 * s + k: 2 * e: 2] = torch.clamp(
                torch.round(noisy * 90.0 + 127.5), 0, 255).to(torch.uint8)
    return out, lines


APRS_OFFSET_HZ = 12_000.0
APRS_DEV_HZ = 3_500.0
APRS_NOISE = 0.02
BAUD = 1200
MARK_HZ, SPACE_HZ = 1200, 2200
AX25_FLAG = [0, 1, 1, 1, 1, 1, 1, 0]


def ax25_frame_bits(info: str) -> list:
    """Unstuffed AX.25 UI frame bits, each byte LSB first: destination
    APRS, source N0CALL, control 0x03, PID 0xF0, the info field, FCS."""
    from directdemod_tpu_torch.ops import crc
    hdr = (bytes((ord(c) << 1) & 0xFF for c in "APRS  ") + bytes([0x60])
           + bytes((ord(c) << 1) & 0xFF for c in "N0CALL") + bytes([0x61]))
    body = hdr + bytes([0x03, 0xF0]) + info.encode()
    bits = [(byte >> i) & 1 for byte in body for i in range(8)]
    return bits + [int(c) for c in crc.fcs_crc16_bits(bits)]


def stuff_bits(bits: list) -> list:
    """HDLC bit stuffing: a 0 after every run of five 1s."""
    out, run = [], 0
    for b in bits:
        out.append(b)
        run = run + 1 if b == 1 else 0
        if run == 5:
            out.append(0)
            run = 0
    return out


def aprs_levels(seconds: float) -> tuple[np.ndarray, list]:
    """NRZI baud levels of an APRS session `seconds` long: 80 idle marks,
    then frames with 30-byte payloads, each between three flags on either
    side, 240 idle bauds between frames, idle marks to the end. Returns
    (levels, the payloads in order)."""
    n_bauds = int(round(seconds * BAUD))
    wire, infos = AX25_FLAG * 3, []
    while True:
        info = f"chip smoke APRS frame {len(infos):07d}."
        add = (stuff_bits(ax25_frame_bits(info)) + AX25_FLAG * 3 + [1] * 240
               + AX25_FLAG * 3)
        if 80 + len(wire) + len(add) + 8 > n_bauds:
            break
        wire += add
        infos.append(info)
    bits = np.ones(n_bauds, np.int64)
    bits[80: 80 + len(wire)] = wire
    return 1 ^ (np.cumsum(bits == 0) & 1), infos     # NRZI: 0 flips the level


def synth_aprs_bytes(seconds: float, device, seed: int = 0,
                     chunk: int = 1 << 24) -> tuple[torch.Tensor, list]:
    """AFSK1200 capture of `seconds` as interleaved uint8 IQ on `device`:
    Bell-202 tones (mark 1200 Hz, space 2200 Hz) of `aprs_levels`, FM with
    3.5 kHz deviation onto a 12 kHz offset, both phase integrals carried in
    fp64 from chunk to chunk, complex noise of 0.02 per component, bytes at
    x100 + 127.5 like an 8-bit SDR (the physical layer of
    tests/test_afsk1200.py::afsk_modulate). Returns (bytes, payloads)."""
    levels, infos = aprs_levels(seconds)
    lev = torch.as_tensor(levels, device=device)
    n = int(round(seconds * FS))
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    tone0 = torch.zeros((), dtype=torch.float64, device=device)
    phase0 = torch.zeros((), dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        baud = torch.clamp(torch.arange(s, e, device=device) * BAUD // FS,
                           max=len(levels) - 1)
        freq = torch.where(lev[baud] == 1, MARK_HZ, SPACE_HZ).double()
        tone = tone0 + torch.cumsum(2 * np.pi * freq / FS, 0)
        tone0 = torch.remainder(tone[-1], 2 * np.pi)
        dphi = 2 * np.pi * (APRS_OFFSET_HZ + APRS_DEV_HZ * torch.cos(tone)) / FS
        phase = phase0 + torch.cumsum(dphi, 0)
        phase0 = torch.remainder(phase[-1], 2 * np.pi)
        for k, part in enumerate((torch.cos(phase), torch.sin(phase))):
            noisy = part + APRS_NOISE * torch.randn(
                e - s, dtype=torch.float64, device=device, generator=gen)
            out[2 * s + k: 2 * e: 2] = torch.clamp(
                torch.round(noisy * 100.0 + 127.5), 0, 255).to(torch.uint8)
    return out, infos


def check(cond, what) -> None:
    """Fail the run (raise) unless `cond`; unlike `assert`, kept under -O."""
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs after one warm-up, timed
    with CUDA events."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def plan_line(ddc, kind: str, channels: int, K: int, J: int, out_len: int,
              dev) -> str:
    """What a K1 (kind "u8") or K4 ("c64") launch chooses on the card: its
    threads a block, resident blocks an SM, passes, staged layout and
    blocks (each walks tiles of T - 1 outputs)."""
    p = ddc.launch_plan("ddc_fm_u8" if kind == "u8" else "ddc_fm_c64", channels, K,
                        J, out_len, dev.index or 0)
    return (f"T {p['T']}, {p['blocks_per_sm']} resident blocks an SM, {p['passes']} "
            f"pass(es) of {p['S']} samples a tile, skew {'on' if p['skew'] else 'off'} "
            f"(L {p['L']}), {p['smem']} B shared a block, {p['grid']} blocks")


def wrapped(d: torch.Tensor) -> torch.Tensor:
    """|angle(exp(1j d))| of a phase difference, in fp64."""
    d = d.double()
    return torch.atan2(torch.sin(d), torch.cos(d)).abs()


def k1_compare(ddc, fe, dev, raw: torch.Tensor, label: str) -> dict:
    """K1 against the plain version and the fp64 oracle on the second
    20,000,000-sample block of the synthetic capture `raw`, as DdcFmStream
    hands it over: the previous block's last K-1 samples of bytes, then the
    block."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.ops import resample as rs
    J, K = fe.stride, fe.ntaps
    blk = constants.PROC_CHUNKSIZE
    s = blk
    off = rs.decim_phase(s, J)
    out_len = rs.decim_count(blk, off, J)
    seg = raw[2 * (s - (K - 1)): 2 * (2 * blk)][2 * off:]
    _, taps_rev, rot, _ = fe.consts(dev)
    c_prev = torch.tensor([1.0 + 0.5j], dtype=torch.complex64, device=dev)

    a_k, c_k = ddc.ddc_fm_u8(seg, taps_rev, rot, c_prev, J, out_len)
    a_p, c_p = ddc.ddc_fm_u8_plain(seg, taps_rev, rot, c_prev, J, out_len)
    torch.cuda.synchronize()
    d = wrapped(a_k - a_p)
    err_max = float(d.max())
    err_p999 = float(torch.quantile(d[: 1 << 24].float(), 0.999))

    # fp64 oracle on the first, a middle and the last 4096 outputs
    w64 = torch.as_tensor(fe.taps_mod[::-1].copy(), dtype=torch.complex128,
                          device=dev)
    rot64 = torch.tensor(fe.rot, dtype=torch.complex128, device=dev)
    oracle_err = 0.0
    for m0 in (0, out_len // 2, out_len - 4096):
        lo = max(m0 - 1, 0)
        b = seg[2 * lo * J: 2 * ((m0 + 4095) * J + K)].double() - 127.5
        x = torch.complex(b[0::2], b[1::2])
        c = x.unfold(0, K, J) @ w64
        prev = torch.cat([c_prev.to(torch.complex128), c[:-1]]) if m0 == 0 \
            else c[:-1]
        cur = c if m0 == 0 else c[1:]
        ref = torch.angle(cur * prev.conj() * rot64)
        oracle_err = max(oracle_err, float(wrapped(a_k[m0:m0 + 4096] - ref).max()))
        if m0 == out_len - 4096:
            c_last_err = abs(complex(c_k.cpu()[0]) - complex(c[-1].cpu()))
            c_last_scale = abs(complex(c[-1].cpu()))
    print(f"{label}: J {J}, out_len {out_len}, kernel vs plain max {err_max:.3e} "
          f"p99.9 {err_p999:.3e}, kernel vs fp64 oracle max {oracle_err:.3e}, "
          f"c_last err {c_last_err:.3e} of |c| {c_last_scale:.3e}, "
          f"c_last kernel vs plain {abs(complex((c_k - c_p).cpu()[0])):.3e}",
          flush=True)
    print(f"{label}: K1 launch: {plan_line(ddc, 'u8', 1, K, J, out_len, dev)}", flush=True)
    check(err_p999 < PLAIN_P999_TOL and err_max < PLAIN_MAX_TOL,
          f"K1 vs plain p99.9 {err_p999} max {err_max}")
    check(oracle_err < ORACLE_TOL, f"K1 vs fp64 oracle {oracle_err}")
    check(c_last_err < 1e-5 * max(c_last_scale, 1.0) + 1e-2,
          f"c_last error {c_last_err}")

    ms_k = cuda_ms(lambda: ddc.ddc_fm_u8(seg, taps_rev, rot, c_prev, J, out_len), 20)
    ms_p = cuda_ms(lambda: ddc.ddc_fm_u8_plain(seg, taps_rev, rot, c_prev, J,
                                               out_len), 5)
    b = seg[: 2 * ((out_len - 1) * J + K)].float() - 127.5
    ms_l = conv_library_ms(torch.complex(b[0::2], b[1::2]), taps_rev, J, 20)
    del b
    bnd = ddc_bound(2 * ((out_len - 1) * J + K), 1, out_len, K)
    print(f"{label}: K1 at J {J} {ms_k:.4f} ms, plain {ms_p:.4f} ms, cuDNN conv1d "
          f"{ms_l:.4f} ms, bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) per "
          f"{blk}-sample block ({blk / ms_k / 1e6:.2f} Gsamp/s kernel, "
          f"{blk / ms_p / 1e6:.2f} Gsamp/s plain) on {card_line()}", flush=True)
    return {"max_abs_err": err_max, "ms": ms_k, "plain_ms": ms_p, "library_ms": ms_l,
            **bnd}


def phase4_decode(ddc, fe, dev) -> tuple[int, torch.Tensor]:
    """Synthesize a 10-minute pass on the card and decode it from the bytes
    held there, twice: a cold run (first use of cuFFT plans, cuDNN and the
    allocator in this process) and a warm one. Then hold K1 against its
    plain version at the shape the decode gave it. Returns the warm run's
    K1 launch count and the capture (for the mesh phases)."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    from directdemod_tpu_torch.ops import resample as rs
    t0 = time.perf_counter()
    raw, truth = synth_pass_bytes(1200, dev, seed=0)
    torch.cuda.synchronize()
    n = raw.shape[0] // 2
    print(f"phase 4: synthesized {n} samples ({raw.shape[0] / 1e9:.2f} GB) "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    src = DeviceRawSource(raw, FS)
    gt = truth[0][40:1040]
    for run in ("cold", "warm"):
        dec = NoaaDecoder(src, OFFSET_HZ, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ddc.LAUNCHES = 0
        t0 = time.perf_counter()
        useful = dec.useful
        sa, sb = dec.get_crude_sync()
        img = dec.get_image()
        acc = dec.get_accurate_sync(use_norm_correlate=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ddc.LAUNCHES
        rate = dec._sync_rate
        cors = [np.corrcoef(img[r, :1040].astype(np.float64)[60:1000],
                            gt[60:1000])[0, 1] for r in range(img.shape[0])]
        stages = {k: round(v, 4) for k, v in dec.stage_seconds.items()}
        print(f"phase 4 ({run}): decode of a {n / FS:.1f} s pass in {wall:.3f} s "
              f"wall ({n / FS / wall:.1f}x real time), stages (CUDA events) "
              f"{json.dumps(stages)}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, useful "
              f"{useful}, syncs {len(sa)}/{len(sb)}, image {img.shape}, median "
              f"row corr {np.median(cors):.4f}, accurate syncs "
              f"{len(acc[0])}/{len(acc[4])}, K1 launches {launches} "
              f"on {card_line()}", flush=True)
        check(useful == 1, "useful == 1")
        for syncs in (sa, sb):
            check(np.all(np.abs(np.diff(syncs) - 0.5 * rate) < 5),
                  "crude syncs 0.5 s apart within 5 samples")
        check(img.shape[0] >= 1150 and img.shape[1] == 2080, f"image {img.shape}")
        check(np.median(cors) > 0.9, "median row correlation > 0.9")
        check(len(acc[1]) > 0 and np.all(np.abs(np.asarray(acc[1]) - 0.5 * FS) < 300),
              "accurate syncs 0.5 s apart within 300 samples")
        check(launches > 0, "the decode launched K1")
    print(f"phase 4 (warm): profiler {json.dumps(dec.profiler.report())}", flush=True)

    # K1 at the decode's own shape: the remainder after block 0 in one call
    J, K = fe.stride, fe.ntaps
    b0 = constants.PROC_CHUNKSIZE
    off = rs.decim_phase(b0, J)
    out_len = rs.decim_count(n - b0, off, J)
    seg = raw[2 * (b0 - (K - 1) + off): 2 * n]
    _, taps_rev, rot, _ = fe.consts(dev)
    c_prev = torch.tensor([1.0 + 0.5j], dtype=torch.complex64, device=dev)
    a_k, _ = ddc.ddc_fm_u8(seg, taps_rev, rot, c_prev, J, out_len)
    a_p, _ = ddc.ddc_fm_u8_plain(seg, taps_rev, rot, c_prev, J, out_len)
    d = wrapped(a_k - a_p)
    err_max = float(d.max())
    err_p999 = float(torch.quantile(d[: 1 << 24].float(), 0.999))
    del a_k, a_p, d
    ms_k = cuda_ms(lambda: ddc.ddc_fm_u8(seg, taps_rev, rot, c_prev, J, out_len), 5)
    ms_p = cuda_ms(lambda: ddc.ddc_fm_u8_plain(seg, taps_rev, rot, c_prev, J,
                                               out_len), 2)
    print(f"phase 4: K1 at the decode's shape ({n - b0} samples, {out_len} "
          f"outputs): vs plain max {err_max:.3e} p99.9 {err_p999:.3e}; K1 "
          f"{ms_k:.4f} ms ({(n - b0) / ms_k / 1e6:.2f} Gsamp/s, "
          f"{2 * (n - b0) / ms_k / 1e6:.1f} GB/s of bytes), plain {ms_p:.4f} ms "
          f"on {card_line()}", flush=True)
    check(err_p999 < PLAIN_P999_TOL and err_max < PLAIN_MAX_TOL,
          f"K1 vs plain p99.9 {err_p999} max {err_max}")
    return launches, raw


def write_iq_wav(path: str, raw: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(raw)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 2, FS, FS * 2, 2, 8))
        f.write(b"data")
        f.write(struct.pack("<I", len(raw)))
        f.write(raw.tobytes())


def run_cli(raw: torch.Tensor, name: str, args: list, log_has: str | None = None,
            expect_ok: bool = True):
    """Write `raw` as the IQ.wav `name` into a temporary directory and run
    the port's CLI there on it with `args` and `-r rep.json`. Fails unless
    it exits 0 (and its log.txt holds `log_has`); returns (stdout, the
    report's first channel, the files the run left, wall seconds). With
    `expect_ok` false it fails unless the CLI exits non-zero, and returns
    its standard error."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        write_iq_wav(os.path.join(tmp, name), raw.cpu().numpy())
        env = dict(os.environ, PYTHONPATH=root)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "directdemod_tpu_torch", *args,
             "-r", "rep.json", name],
            cwd=tmp, env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        sys.stderr.write(proc.stderr[-4000:])
        if not expect_ok:
            check(proc.returncode != 0, "the CLI exits non-zero")
            return proc.stderr
        check(proc.returncode == 0, f"CLI exit code {proc.returncode}")
        if log_has is not None:
            with open(os.path.join(tmp, "log.txt")) as f:
                check(log_has in f.read(), f"log.txt holds {log_has!r}")
        with open(os.path.join(tmp, "rep.json")) as f:
            ch = json.load(f)["channels"][0]
        return proc.stdout, ch, set(os.listdir(tmp)), wall


def phase5_cli(dev) -> None:
    """The NOAA CLI on a 30-second IQ.wav synthesized on the card."""
    raw, _ = synth_pass_bytes(60, dev, seed=2)
    name = "SDRSharp_20170830_073907Z_137590000Hz_IQ.wav"
    _, ch, files, wall = run_cli(raw, name, ["-c", "137590000", "-f", "137620000",
                                             "-d", "noaa", "-sync"])
    stem = name.split(".")[0]
    for f in (stem + "_f1.png", stem + "_f1.csv", "log.txt"):
        check(f in files, f"{f} written")
    check(ch["usefulness"] == 1 and ch["device"].startswith("cuda"), f"report {ch}")
    print(f"phase 5: CLI rc 0 in {wall:.1f} s, decodeSeconds "
          f"{ch['decodeSeconds']}, files {ch['filesCreated']}", flush=True)


def k2_compare(peaks, y: torch.Tensor, lookahead: int, delta: float,
               label: str, plain_reps: int) -> dict:
    """K2 against its plain version on the walk over y[:n - lookahead]
    with its forward-window extrema, event for event; then both timed with
    CUDA events. Returns the kernel-table numbers; max_abs_err is the
    largest difference over the event fields (inf if the counts differ)."""
    limit = y.shape[0] - lookahead
    fmax, fmin = peaks.forward_window_extrema(y, lookahead)
    args = (y[:limit].contiguous(), fmax[:limit].contiguous(),
            fmin[:limit].contiguous(), delta)
    ev_k = peaks.lookahead_walk(*args)
    ev_p = peaks.lookahead_walk_plain(*args)
    torch.cuda.synchronize()
    if ev_k[0].shape != ev_p[0].shape:
        err, mismatched = float("inf"), abs(ev_k[0].shape[0] - ev_p[0].shape[0])
    else:
        diff = torch.stack([(a.double() - b.double()).abs()
                            for a, b in zip(ev_k, ev_p)])
        err = float(diff.max()) if diff.numel() else 0.0
        mismatched = int((diff > 0).any(dim=0).sum())
    ms_k = cuda_ms(lambda: peaks.lookahead_walk(*args), 5)
    ms_p = cuda_ms(lambda: peaks.lookahead_walk_plain(*args), plain_reps)
    # y, fmax, fmin read once (float32); an event is 8 + 8 + 4 + 1 bytes;
    # a step is ~6 compares and selects
    bnd = bound(12 * limit + 21 * ev_k[0].shape[0] + 8, 6 * limit)
    print(f"{label}: K2 over {limit} samples, lookahead {lookahead}, delta "
          f"{delta}: {ev_k[0].shape[0]} events, {mismatched} mismatched vs "
          f"plain (max field difference {err}); K2 {ms_k:.4f} ms "
          f"({ms_k * 1e6 / limit:.2f} ns per sample), plain {ms_p:.4f} ms, bound "
          f"{bnd['bound_ms']:.5f} ms ({bnd['bound_by']}) on {card_line()}", flush=True)
    check(err == 0.0 and ev_k[0].shape[0] > 0,
          f"K2 events equal the plain version's ({mismatched} mismatched)")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p, "library_ms": None,
            **bnd}


def stress_edges(n: int, seed: int, device) -> torch.Tensor:
    """|edge correlation| of a noisy square wave (the stress input of
    tests/test_peaks_pallas.py), float32 on `device`."""
    rng = np.random.default_rng(seed)
    bf = np.sign(np.sin(np.arange(n) / 9.0) + 0.3 * rng.standard_normal(n))
    y = np.abs(np.convolve(bf, np.concatenate([-np.ones(9), np.ones(9)]),
                           "same") / 18)
    return torch.as_tensor(y, dtype=torch.float32, device=device)


def phase8_afsk_decode(ddc, peaks, dev) -> tuple[int, int, dict]:
    """Synthesize a 10-minute APRS capture on the card and decode it from
    the bytes held there, cold and then warm; every planted frame must come
    back, in order. Then hold K2 against its plain version on the first
    2^21 samples of that decode's own edge strength and on the whole of it,
    and measure its chunks there (`k2_chunks`). Returns the warm run's K1
    and K2 launch counts and the K2 numbers of the whole walk."""
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
    t0 = time.perf_counter()
    raw, infos = synth_aprs_bytes(600.0, dev, seed=0)
    torch.cuda.synchronize()
    n = raw.shape[0] // 2
    print(f"phase 8: synthesized {n} samples ({raw.shape[0] / 1e9:.2f} GB, "
          f"{len(infos)} frames) in {time.perf_counter() - t0:.1f} s", flush=True)
    src = DeviceRawSource(raw, FS)
    for run in ("cold", "warm"):
        dec = Afsk1200Decoder(src, APRS_OFFSET_HZ, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ddc.LAUNCHES = peaks.LAUNCHES = 0
        t0 = time.perf_counter()
        frames = dec.get_frames()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ddc.LAUNCHES, peaks.LAUNCHES
        got = [f.info for f in frames]
        stages = {k: round(v, 4) for k, v in dec.stage_seconds.items()}
        print(f"phase 8 ({run}): decode of a {n / FS:.1f} s capture in "
              f"{wall:.3f} s wall ({n / FS / wall:.1f}x real time), stages "
              f"(CUDA events) {json.dumps(stages)}, peak "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, useful "
              f"{dec.useful}, {len(got)}/{len(infos)} frames, K1 launches "
              f"{launches[0]}, K2 launches {launches[1]} on {card_line()}",
              flush=True)
        first_bad = next((i for i, (a, b) in enumerate(zip(got, infos)) if a != b),
                         None)
        check(got == infos, f"{len(got)} frames decoded of {len(infos)} planted, "
                            f"first difference at {first_bad}")
        check(all(f.source.startswith("N0CALL") and f.destination.startswith("APRS")
                  and f.control == 0x03 and f.protocol == 0xF0 for f in frames),
              "AX.25 headers")
        check(dec.useful == 1, "useful == 1")
        check(launches[0] > 0 and launches[1] > 0, "the decode launched K1 and K2")

    from directdemod_tpu_torch import constants
    _, edges = Afsk1200Decoder(src, APRS_OFFSET_HZ, device=dev)._edges()
    del raw, src
    lookahead = int(constants.AFSK_DEFAULT_BW // constants.AFSK_BAUDRATE * 0.65)
    k2_compare(peaks, edges[: (1 << 21) + lookahead], lookahead, 0.0,
               "phase 8 (decode's edges, first 2^21 samples)", 1)
    k2 = k2_compare(peaks, edges, lookahead, 0.0,
                    "phase 8 (decode's whole edge strength)", 1)
    return launches[0], launches[1], {**k2, **k2_chunks(peaks, edges, lookahead)}


def k2_chunks(peaks, edges: torch.Tensor, lookahead: int) -> dict:
    """K2's chunks on the AFSK decode's whole walk: the stitch's steps at
    the default chunk length, the time at other lengths, and the time of
    one walker over the whole walk (a single chunk), whose time a step
    gives the dependent-chain bound: (chunk + the stitch's steps) steps of
    one walk."""
    limit = edges.shape[0] - lookahead
    fmax, fmin = peaks.forward_window_extrema(edges, lookahead)
    args = (edges[:limit], fmax[:limit].contiguous(), fmin[:limit].contiguous(), 0.0)
    stats = {}
    peaks.lookahead_walk(*args, stats=stats)
    steps = stats["stitch_steps"].double()
    out = {"chunk": stats["chunk"], "chunks": stats["chunks"],
           "stitch_steps_max": int(steps.max()),
           "stitch_steps_mean": float(steps.mean()),
           "unmet_chunks": int((~stats["met"]).sum())}
    print(f"phase 8: K2 over the whole walk ({limit} samples): {out['chunks']} "
          f"chunks of {out['chunk']}, stitch {out['stitch_steps_mean']:.1f} steps "
          f"a chunk (largest {out['stitch_steps_max']}, {int(steps.sum())} in all), "
          f"{out['unmet_chunks']} chunks that never met a speculative walk",
          flush=True)
    sweep = {L: cuda_ms(lambda: peaks.lookahead_walk(*args, chunk=L), 3)
             for L in (4096, 8192, 16384, 32768, 65536)}
    one = cuda_ms(lambda: peaks.lookahead_walk(*args, chunk=limit), 1)
    step_ns = one * 1e6 / limit
    out["chain_bound_ms"] = (out["chunk"] + float(steps.sum())) * step_ns * 1e-6
    out["chunk_ms"] = {str(L): ms for L, ms in sweep.items()}
    out["one_walker_ms"] = one
    print(f"phase 8: K2 by chunk length {json.dumps({L: round(ms, 4) for L, ms in sweep.items()})} "
          f"ms; one walker over the whole walk {one:.4f} ms ({step_ns:.2f} ns a "
          f"step), so the chain bound ({out['chunk']} + {int(steps.sum())} steps) "
          f"{out['chain_bound_ms']:.4f} ms on {card_line()}", flush=True)
    return out


def phase9_afsk_cli(dev) -> None:
    """The AFSK1200 CLI on a 30-second APRS IQ.wav synthesized on the card."""
    raw, infos = synth_aprs_bytes(30.0, dev, seed=2)
    out, ch, _, wall = run_cli(raw, "aprs_145825000Hz_IQ.wav",
                               ["-c", "145813000", "-f", "145825000",
                                "-d", "afsk1200"])
    check(infos[-1] in out, f"payload {infos[-1]!r} printed")
    check(ch["usefulness"] == 1 and ch["device"].startswith("cuda"), f"report {ch}")
    print(f"phase 9: AFSK CLI rc 0 in {wall:.1f} s, decodeSeconds "
          f"{ch['decodeSeconds']}, printed {out.strip()!r}", flush=True)


# ---------------------------------------------------------------- PSK slice
FC_OFFSET_HZ = 5_000            # channel offset of the Funcube captures
FC_CARRIER_ERR_HZ = 200         # carrier error on top of it
FC_SYNC = "101000110001000000000001010111100"
FC_SPACING_S = 4.98
MM_OFFSET_HZ = 4_000            # Meteor channel offset
MM_CARRIER_ERR_HZ = 100
MM_SPACING_S = 0.11
PSK_NOISE = 2.0                 # complex noise per component, in byte units
# Decoded sync minus the planted frame's first sample, measured by
# tests/test_torch_psk_synth.py on these synthesizers: the correlation
# reports the needle's centre, behind the low-pass's delay.
FC_SYNC_DELAY = 28_355
MM_SYNC_DELAY = 872.5
FC_SYNC_TOL = 40                # samples, around FC_SYNC_DELAY
MM_SYNC_TOL = 20.0


def _psk_bytes(out: torch.Tensor, s: int, e: int, bb: torch.Tensor,
               freq_hz: int, gen: torch.Generator) -> None:
    """Samples [s, e) of the complex baseband `bb` (float64 I, Q pairs as a
    complex128 tensor) moved to +freq_hz, plus noise, as uint8 IQ bytes at
    x + 127.5 into `out`. The carrier phase takes (freq * t) mod fs in
    exact integers, so it stays exact at any sample index."""
    dev = bb.device
    t = torch.arange(s, e, dtype=torch.int64, device=dev)
    ph = (2 * np.pi / FS) * torch.remainder(freq_hz * t, FS).double()
    x = bb * torch.polar(torch.ones_like(ph), ph)
    for k, part in enumerate((x.real, x.imag)):
        noisy = part + PSK_NOISE * torch.randn(e - s, dtype=torch.float64,
                                               device=dev, generator=gen)
        out[2 * s + k: 2 * e: 2] = torch.clamp(torch.round(noisy + 127.5),
                                               0, 255).to(torch.uint8)


def funcube_frames(seconds: float) -> list:
    """Planted frame times: every 4.98 s from 1.0 s while the 33-bit sync
    and 0.2 s after it fit."""
    out, ft = [], 1.0
    while ft + 33 / 1200 + 0.2 < seconds:
        out.append(ft)
        ft += FC_SPACING_S
    return out


def clear_false_syncs(bits: np.ndarray, sync: np.ndarray, keep: np.ndarray,
                      margin: int) -> None:
    """Flip filler bits until no window of len(sync) bits clear of the
    planted frames (`keep`) lies within `margin` bits of the sync or of its
    complement. The detectors fire on near-matches (Funcube: 4 of
    33 bits), which random filler data produces about once a minute; the
    smoke run holds the decoders to the planted frames only."""
    L = len(sync)
    # windows that overlap a planted frame fire next to it, in its cluster
    touches = np.convolve(keep, np.ones(L, int))[L - 1:len(bits)] > 0
    for _ in range(64):
        win = np.lib.stride_tricks.sliding_window_view(bits, L)
        d = np.count_nonzero(win != sync, axis=1)
        bad = np.flatnonzero(((d < margin) | (d > L - margin)) & ~touches)
        if len(bad) == 0:
            return
        for w in bad:
            diff = bits[w:w + L] != sync
            dw = int(diff.sum())
            if margin <= dw <= L - margin:
                continue                # an earlier flip fixed it
            # move the window away from the sync (or its complement)
            j = np.flatnonzero(~diff if dw < margin else diff)
            bits[w + j[len(j) // 2]] ^= 1
    raise RuntimeError("could not clear the filler of false syncs")


def synth_funcube_bytes(seconds: float, device, seed: int = 0,
                        chunk: int = 1 << 25) -> tuple[torch.Tensor, np.ndarray]:
    """Funcube capture of `seconds` as interleaved uint8 IQ on `device`: 1200
    bps random bits (each spread over 10 symbols at 12 ksym/s, rectangular)
    at +-90 (filler kept 8 bits from the sync, `clear_false_syncs`), the
    33-bit frame sync at `funcube_frames`, on a 5 kHz offset
    with a 200 Hz carrier error, complex noise of 2 per component (the
    signal of tests/test_psk_sync.py::_bpsk_capture, quantized like an 8-bit
    SDR). Returns (bytes, first sample of each planted frame)."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * FS))
    bits = rng.integers(0, 2, n * 1200 // FS + 40)
    sync = np.asarray([int(c) for c in FC_SYNC])
    keep = np.zeros(len(bits), bool)
    starts = []
    for ft in funcube_frames(seconds):
        p = int(ft * 1200)
        bits[p:p + 33] = sync
        keep[p:p + 33] = True
        starts.append(-(-p * FS // 1200))
    clear_false_syncs(bits, sync, keep, 8)
    lev = torch.as_tensor(bits * 2 - 1, dtype=torch.float64, device=device) * 90.0
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.int64, device=device)
        bb = lev[t * 1200 // FS].to(torch.complex128)
        _psk_bytes(out, s, e, bb, FC_OFFSET_HZ + FC_CARRIER_ERR_HZ, gen)
    return out, np.asarray(starts, np.int64)


def meteor_frames(seconds: float) -> list:
    out, ft = [], 0.05
    while ft + 60 / 72000 + 0.03 < seconds:
        out.append(ft)
        ft += MM_SPACING_S
    return out


def synth_meteor_bytes(seconds: float, device, seed: int = 1,
                       chunk: int = 1 << 25) -> tuple[torch.Tensor, np.ndarray]:
    """Meteor-M2 capture of `seconds` as interleaved uint8 IQ on `device`:
    72 ksym/s QPSK (rectangular symbols, +-64 on each rail), the 120-entry
    sync on the I and Q rails (60 symbols) every 0.11 s, on a 4 kHz offset
    with a 100 Hz carrier error, complex noise of 2 per component (the
    signal of tests/test_psk_sync.py::_qpsk_capture, quantized). Returns
    (bytes, first sample of each planted frame)."""
    from directdemod_tpu_torch.models.meteorm2 import _SYNC
    rng = np.random.default_rng(seed)
    n = int(round(seconds * FS))
    n_sym = n * 72000 // FS + 200
    bi, bq = rng.integers(0, 2, n_sym), rng.integers(0, 2, n_sym)
    starts = []
    for ft in meteor_frames(seconds):
        p = int(ft * 72000)
        bi[p:p + 60] = _SYNC[0::2]
        bq[p:p + 60] = _SYNC[1::2]
        starts.append(-(-p * FS // 72000))
    sym = torch.complex(torch.as_tensor(bi * 2 - 1, dtype=torch.float64),
                        torch.as_tensor(bq * 2 - 1, dtype=torch.float64)
                        ).to(device) * 64.0
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.int64, device=device)
        _psk_bytes(out, s, e, sym[t * 72000 // FS],
                   MM_OFFSET_HZ + MM_CARRIER_ERR_HZ, gen)
    return out, np.asarray(starts, np.int64)


def matched_frames(syncs, starts, delay: float, tol: float) -> int:
    """How many planted frames (first samples `starts`) have a decoded sync
    within `tol` of start + delay."""
    syncs = np.sort(np.asarray(syncs, np.float64))
    if len(syncs) == 0:
        return 0
    want = np.asarray(starts, np.float64) + delay
    pos = np.searchsorted(syncs, want)
    left = syncs[np.clip(pos - 1, 0, len(syncs) - 1)]
    right = syncs[np.clip(pos, 0, len(syncs) - 1)]
    return int(np.sum(np.minimum(np.abs(left - want), np.abs(right - want)) <= tol))


def k3_streams(n: int, seed: int = 0) -> dict:
    """Filtered-baseband-like test streams for K3 (complex64, host): BPSK
    at 1200 bps spread to 12 ksym/s with the Funcube sync planted every
    0.5 s, and 72 ksym/s QPSK with the Meteor sync every 0.11 s, each on a
    small carrier offset with complex noise."""
    from directdemod_tpu_torch.models.meteorm2 import _SYNC
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    bits = rng.integers(0, 2, n * 1200 // FS + 40)
    for p in range(40, len(bits) - 40, 600):
        bits[p:p + 33] = [int(c) for c in FC_SYNC]
    bb = (bits[t * 1200 // FS] * 2 - 1) * 90.0
    noise = 2.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    bpsk = bb * np.exp(2j * np.pi * 180.0 * t / FS) + noise
    n_sym = n * 72000 // FS + 200
    bi, bq = rng.integers(0, 2, n_sym), rng.integers(0, 2, n_sym)
    for p in range(100, n_sym - 100, 7920):
        bi[p:p + 60], bq[p:p + 60] = _SYNC[0::2], _SYNC[1::2]
    k = t * 72000 // FS
    qpsk = ((bi[k] * 2 - 1) + 1j * (bq[k] * 2 - 1)) * 64.0 \
        * np.exp(2j * np.pi * 4100.0 * t / FS) + noise
    return {"bpsk": bpsk.astype(np.complex64), "qpsk": qpsk.astype(np.complex64)}


def k3_compare(pll, kind: str, x: np.ndarray, dev, segments: int = 1) -> dict:
    """K3 against its plain version on the stream x: sequential (one
    lane of each stage warp) or `segments` segments (one launch, a lane
    each). Symbol indices, minsync flags and needle choices must be equal;
    prints the largest phase difference. Times K3 with CUDA events and the
    plain version with the host clock (one run)."""
    from directdemod_tpu_torch.models.funcube import FuncubeDecoder
    from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
    from directdemod_tpu_torch.io.sources import ArraySource
    cls = FuncubeDecoder if kind == "bpsk" else MeteorM2Decoder
    det = cls(ArraySource(x[:16], FS), 0)
    p, s0, s1 = det.p, det.cfg.sym_sync, det.cfg.sym_sync_alt
    xc = torch.from_numpy(x)
    xd = xc.to(dev)

    def run(xx):
        if segments == 1:
            return pll.symbol_scan(p, xx, pll.initial_state(p, len(s0), 1, xx.device),
                                   s0, s1)[1]
        return pll.symbol_scan_segments(p, xx, s0, s1, segments, 2000)[0]

    got = run(xd)
    stats = {k: sum(v) for k, v in pll.LAST_STATS.items()}
    t0 = time.perf_counter()
    want = run(xc)
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    same = got.count == want.count and all(
        torch.equal(a.cpu(), b) for a, b in
        zip((got.a_idx, got.minsync, got.chosen), (want.a_idx, want.minsync, want.chosen)))
    err = float((got.phase_out.cpu() - want.phase_out).abs().max()) \
        if got.count == want.count else float("inf")
    ms = cuda_ms(lambda: run(xd), 3)
    # per symbol: two complex64 samples read (B and A), 14 bytes of outputs,
    # ~100 float32 operations of the step
    bnd = bound(30 * got.count, 100 * got.count)
    stages = {}
    if segments == 1:
        # the measurement build: each stage warp's clocks on its own work;
        # the longest stage's share of P's wall, times the time, is the
        # longest chain's time alone
        cyc = pll.stage_cycles(p, xd, pll.initial_state(p, len(s0), 1, dev), s0, s1)
        stages = {k: v / got.count for k, v in zip(("P", "C", "M", "wall", "P_reads"), cyc)}
        stages["chain_bound_ms"] = ms * max(cyc[:3]) / cyc[3]
        print(f"phase 10 ({kind}): stage clocks a symbol (measurement build) P "
              f"{stages['P']:.0f} (its sample reads {stages['P_reads']:.0f}, the rest "
              f"{stages['P'] - stages['P_reads']:.0f}), C {stages['C']:.0f}, M "
              f"{stages['M']:.0f}, P's wall {stages['wall']:.0f}: the longest chain "
              f"alone {stages['chain_bound_ms']:.4f} ms", flush=True)
    print(f"phase 10 ({kind}, {segments} segment(s)): K3 over {len(x)} samples, "
          f"{got.count} symbols ({int(got.minsync.sum())} minsync; window misses "
          f"{stats['window_misses']} of {2 * got.count} reads, sincos fallbacks "
          f"{stats['sincos_fallbacks']}): a_idx, "
          f"minsync, chosen equal to the plain version: {same}; largest phase "
          f"difference {err:.3e} rad; K3 {ms:.4f} ms ({ms * 1e6 / got.count:.1f} ns "
          f"a symbol), plain {plain_ms:.1f} ms, bound {bnd['bound_ms']:.5f} ms "
          f"({bnd['bound_by']}) on {card_line()}", flush=True)
    check(same and got.count > 0, f"K3 {kind} equals its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "symbols": got.count, **stats, **bnd, **stages}


def psk_decode(cls, raw: torch.Tensor, offset: float, dev, label: str, **kw):
    """Decode the bytes held on the card with a fresh decoder; returns
    (syncs, decoder, wall seconds, K3 launches)."""
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.ops import pll
    dec = cls(DeviceRawSource(raw, FS), offset, device=dev, **kw)
    torch.cuda.reset_peak_memory_stats(dev)
    pll.LAUNCHES = 0
    t0 = time.perf_counter()
    syncs = dec.get_syncs()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pll.LAUNCHES
    n = raw.shape[0] // 2
    stages = {k: round(v, 4) for k, v in dec.stage_seconds.items()}
    print(f"{label}: decode of a {n / FS:.1f} s capture in {wall:.3f} s wall "
          f"({n / FS / wall:.1f}x real time), stages (CUDA events) "
          f"{json.dumps(stages)}, peak "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, useful "
          f"{dec.useful}, {len(syncs)} syncs, K3 launches {launches} on "
          f"{card_line()}", flush=True)
    return syncs, dec, wall, launches


def phase11_funcube(dev) -> tuple[int, torch.Tensor]:
    """A 10-minute Funcube capture synthesized on the card and decoded from
    the bytes held there, sequential, cold and then warm (the block loop,
    K3 once a block with the state carried); every planted frame after the
    first must come back at FC_SYNC_DELAY. Then the first 60 s with 32
    segments on the whole-capture path against the sequential decode of
    the same 60 s. Returns the warm run's K3 launch count and the capture's
    first 64 s (for the mesh phase)."""
    from directdemod_tpu_torch.models.funcube import FuncubeDecoder
    t0 = time.perf_counter()
    raw, starts = synth_funcube_bytes(600.0, dev, seed=0)
    torch.cuda.synchronize()
    print(f"phase 11: synthesized {raw.shape[0] // 2} samples ({raw.shape[0] / 1e9:.2f} "
          f"GB, {len(starts)} frames) in {time.perf_counter() - t0:.1f} s", flush=True)
    for run in ("cold", "warm"):
        syncs, dec, _, launches = psk_decode(FuncubeDecoder, raw, FC_OFFSET_HZ, dev,
                                             f"phase 11 ({run})")
        got = matched_frames(syncs, starts[1:], FC_SYNC_DELAY, FC_SYNC_TOL)
        check(dec.useful == 1, "useful == 1")
        check(len(syncs) == len(starts) - 1 and got == len(starts) - 1,
              f"{got} of {len(starts) - 1} frames after the first at "
              f"+{FC_SYNC_DELAY} +- {FC_SYNC_TOL}, {len(syncs)} syncs")
        check(launches > 0, "the decode launched K3")
    head = raw[: 2 * 60 * FS]
    head64 = raw[: 2 * 64 * FS]
    seq, _, _, _ = psk_decode(FuncubeDecoder, head, FC_OFFSET_HZ, dev,
                              "phase 11 (first 60 s, sequential)")
    par, pdec, _, plaunch = psk_decode(FuncubeDecoder, head, FC_OFFSET_HZ, dev,
                                       "phase 11 (first 60 s, 32 segments)",
                                       n_segments=32)
    far = max((min(abs(a - b) for b in par) for a in seq), default=float("inf"))
    print(f"phase 11: 32-segment syncs vs sequential: {len(par)} vs {len(seq)}, "
          f"largest distance {far:.1f} samples", flush=True)
    check(pdec.useful == 1 and len(par) == len(seq) > 0 and far < 0.01 * FS
          and plaunch == 1, "segmented 60 s agrees with sequential")
    return launches, head64


def phase12_meteor(dev) -> tuple[int, torch.Tensor]:
    """A 2-minute Meteor capture (8.64 M symbols) synthesized on the card
    and decoded sequentially, cold and warm: useful and >= 95 % of the
    planted frames at MM_SYNC_DELAY. Then 32 segments against it. Returns
    the warm run's K3 launch count and the capture."""
    from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
    raw, starts = synth_meteor_bytes(120.0, dev, seed=1)
    print(f"phase 12: synthesized {raw.shape[0] // 2} samples, {len(starts)} "
          f"frames", flush=True)
    for run in ("cold", "warm"):
        syncs, dec, _, launches = psk_decode(MeteorM2Decoder, raw, MM_OFFSET_HZ,
                                             dev, f"phase 12 ({run})")
        got = matched_frames(syncs, starts, MM_SYNC_DELAY, MM_SYNC_TOL)
        print(f"phase 12 ({run}): {got} of {len(starts)} planted frames at "
              f"+{MM_SYNC_DELAY} +- {MM_SYNC_TOL}", flush=True)
        check(dec.useful == 1 and got >= 0.95 * len(starts),
              f"{got} of {len(starts)} frames")
        check(launches > 0, "the decode launched K3")
    par, pdec, _, _ = psk_decode(MeteorM2Decoder, raw, MM_OFFSET_HZ, dev,
                                 "phase 12 (32 segments)", n_segments=32)
    got_par = matched_frames(par, starts, MM_SYNC_DELAY, MM_SYNC_TOL)
    print(f"phase 12 (32 segments): {got_par} of {len(starts)} planted frames",
          flush=True)
    # the approximate mode: a segment re-locks over its warm-up and can
    # miss frames near its edges (docs/experiments.md D13)
    check(pdec.useful == 1 and got_par >= 0.5 * len(starts),
          f"segmented: {got_par} of {len(starts)} frames")
    return launches, raw


def phase13_psk_cli(dev) -> None:
    """The Funcube CLI with --freqshift and the Meteor CLI with
    --segments=8, each on a 30-second IQ.wav synthesized on the card."""
    raw, starts = synth_funcube_bytes(30.0, dev, seed=2)
    _, ch, files, wall = run_cli(raw, "fc_145865000Hz_IQ.wav",
                                 ["-c", "145865000", "-f", "145870000",
                                  "-d", "funcube", "--freqshift"])
    check(ch["usefulness"] == 1 and ch["device"].startswith("cuda")
          and "fc_145865000Hz_IQ_f1.csv" in files, f"funcube report {ch}")
    print(f"phase 13: funcube --freqshift CLI rc 0 in {wall:.1f} s, decodeSeconds "
          f"{ch['decodeSeconds']}", flush=True)
    raw, starts = synth_meteor_bytes(30.0, dev, seed=3)
    _, ch, files, wall = run_cli(raw, "mm_137100000Hz_IQ.wav",
                                 ["-c", "137096000", "-f", "137100000",
                                  "-d", "meteor", "--segments=8"])
    check(ch["usefulness"] == 1 and ch["device"].startswith("cuda")
          and "mm_137100000Hz_IQ_f1.csv" in files, f"meteor report {ch}")
    print(f"phase 13: meteor --segments=8 CLI rc 0 in {wall:.1f} s, decodeSeconds "
          f"{ch['decodeSeconds']}", flush=True)


# ------------------------------------------------- FM, stream and bank slice
FM_OFFSET_HZ = 30_000           # channel offset of the FM captures
FM_DEV_HZ = 5_000               # peak deviation
FM_TONES = ((400, 0.5, 0.0), (1100, 0.3, 1.0), (2300, 0.2, 2.0))  # Hz, amp, phase
FM_AMP = 90.0
FM_NOISE = 2.0                  # complex noise per component
# the three satellites of one recording centred at 137.5 MHz
NOAA_BANK_HZ = (120_000, 412_500, -400_000)     # NOAA-15, -18, -19
# H100 SXM peaks for the bound: HBM3 bandwidth and dense fp32 rate
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 peak."""
    t_b, t_o = n_bytes / PEAK_BYTES_S * 1e3, n_ops / PEAK_FP32_S * 1e3
    return {"bound_ms": max(t_b, t_o), "bound_by": "bytes" if t_b >= t_o else "operations"}


def ddc_bound(n_in_bytes: int, channels: int, out_len: int, taps: int) -> dict:
    """Bound of one K1 or K4 call: its input read once, the audio and c_last
    written once; 8 operations a complex tap and ~12 for the discriminator
    (the atan2 counted as one) per output and channel."""
    return bound(n_in_bytes + channels * (4 * out_len + 8),
                 channels * out_len * (8 * taps + 12))


def fm_message(t: torch.Tensor) -> torch.Tensor:
    """The modulating audio m(t) of the FM captures, peak <= 1, at times t
    (seconds, float64)."""
    return sum(a * torch.sin(2 * np.pi * f * t + p) for f, a, p in FM_TONES)


def synth_fm(n: int, device, seed: int = 0, chunk: int = 1 << 25,
             host: bool = True, offsets=(FM_OFFSET_HZ,)):
    """An FM capture of n complex64 samples: for each carrier of `offsets`,
    FM_AMP / len(offsets) e^{j phi} with phi the carrier plus 2 pi FM_DEV_HZ
    times the integral of `fm_message`, both in closed form from exact
    integer phases (f n mod fs), plus complex noise of FM_NOISE per
    component. Made on `device` a chunk at a time; returned as a host numpy
    array (`host`) or a tensor on `device`."""
    out = np.empty(n, np.complex64) if host else \
        torch.empty(n, dtype=torch.complex64, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        i = torch.arange(s, e, dtype=torch.int64, device=device)
        mod = torch.zeros(e - s, dtype=torch.float64, device=device)
        for f, a, p in FM_TONES:
            arg = (2 * np.pi / FS) * torch.remainder(f * i, FS).double() + p
            mod += FM_DEV_HZ * a / f * (np.cos(p) - torch.cos(arg))
        x = torch.complex(*(torch.randn(2, e - s, dtype=torch.float64, device=device,
                                        generator=gen) * FM_NOISE))
        for f in offsets:
            ph = (2 * np.pi / FS) * torch.remainder(f * i, FS).double() + mod
            x += torch.polar(torch.full_like(ph, FM_AMP / len(offsets)), ph)
        x = x.to(torch.complex64)
        if host:
            out[s:e] = x.cpu().numpy()
        else:
            out[s:e] = x
    return out


def fm_audio_times(n: int, stride: int, decim_rate: float, audio_rate: int,
                   block: int, ntaps: int = 151) -> np.ndarray:
    """The capture time (s) each sample of `FmDecoder.get_audio()` (strict)
    stands for on an n-sample capture: block by block, the front end's
    output m measures the phase step over the J samples before m*J, behind
    the FIR's (K-1)/2 delay; the per-block Fourier resample puts output i at
    input position i * N / M."""
    from directdemod_tpu_torch.ops import resample as rs
    from directdemod_tpu_torch.stream.plan import plan_blocks
    ts = []
    for s, e in plan_blocks(n, block):
        cnt = rs.decim_count(e - s, rs.decim_phase(s, stride), stride)
        m0 = -(-s // stride)
        if s == 0:              # block 0 drops its first output
            m0, cnt = m0 + 1, cnt - 1
        num = int(audio_rate * cnt / decim_rate)
        m = m0 + np.arange(num) * (cnt / num)
        ts.append((m * stride - stride / 2 - (ntaps - 1) / 2) / FS)
    return np.concatenate(ts)


def fm_correlation(audio, times: np.ndarray, device) -> tuple[float, float]:
    """Correlation of decoded audio with `fm_message` at `times`, at the
    best of a few common lags (+-40 us, to absorb the half-sample
    conventions of the resample); returns (correlation, lag in us)."""
    a = torch.as_tensor(np.asarray(audio), dtype=torch.float64, device=device)
    t = torch.as_tensor(times, dtype=torch.float64, device=device)
    check(a.shape == t.shape and bool(torch.isfinite(a).all()),
          f"audio {tuple(a.shape)} finite, {tuple(t.shape)} times")

    def corr(x, y):
        x, y = x - x.mean(), y - y.mean()
        return float((x * y).sum() / torch.sqrt((x * x).sum() * (y * y).sum()))
    mid = slice(len(a) // 2, len(a) // 2 + min(len(a) // 2, 1 << 20))
    lags = np.linspace(-40e-6, 40e-6, 81)
    best = max(lags, key=lambda d: corr(a[mid], fm_message(t[mid] + d)))
    return corr(a, fm_message(t + best)), float(best * 1e6)


def conv_library_ms(xs: torch.Tensor, taps_rev: torch.Tensor, J: int,
                    reps: int) -> float:
    """The library call of K1 and K4, timed: one cuDNN `F.conv1d` computing
    the same windows (TF32 is off in the port) from the complex64 samples
    `xs` as (1, 2, N) float32, checked against `ddc.conv_windows` first."""
    import torch.nn.functional as F
    from directdemod_tpu_torch.ops.ddc import conv_windows
    K = taps_rev.shape[-1]
    xr = torch.view_as_real(xs).T.reshape(1, 2, -1).contiguous()
    t = taps_rev.reshape(-1, K)
    weight = torch.stack([torch.stack([t.real, -t.imag], 1),
                          torch.stack([t.imag, t.real], 1)], 1).reshape(-1, 2, K)
    weight = weight.contiguous()
    y = F.conv1d(xr, weight, stride=J).reshape(t.shape[0], 2, -1)
    check(torch.allclose(y[:, 0, :64], conv_windows(xs, taps_rev, J, 64).real,
                         rtol=1e-4, atol=1e-2), "the library call computes the windows")
    del y
    return cuda_ms(lambda: F.conv1d(xr, weight, stride=J), reps)


def ddc_compare(ddc, kind: str, x: torch.Tensor, samples, fe, c_prev,
                out_len: int, label: str, reps: int = 20, plain_reps: int = 5,
                timed: bool = True, head: int = 0) -> dict:
    """K1 (kind "u8", x raw bytes) or K4 ("c64", x complex64 samples)
    against its plain version (fp32 bars) and the fp64 oracle on the first,
    a middle and the last 4,096 outputs of every channel (`samples(lo, hi)`
    gives samples [lo, hi) as complex128 on the card), c_last against the
    oracle's c[out_len - 1]; then K, plain and the cuDNN `F.conv1d` of the
    same windows (the library call) timed with CUDA events. The kernel gets
    x's first `head` samples as its `head=`, as a stream hands it its
    history; the plain version gets x whole."""
    fn, plain = ((ddc.ddc_fm_u8, ddc.ddc_fm_u8_plain) if kind == "u8"
                 else (ddc.ddc_fm_c64, ddc.ddc_fm_c64_plain))
    J, K = fe.stride, fe.ntaps
    _, taps_rev, rot, _ = fe.consts(x.device)
    cut = head * (2 if kind == "u8" else 1)
    xk, hk = (x[cut:], x[:cut]) if head else (x, None)

    def kernel():
        return fn(xk, taps_rev, rot, c_prev, J, out_len, head=hk)
    a_k, c_k = kernel()
    a_p, _ = plain(x, taps_rev, rot, c_prev, J, out_len)
    torch.cuda.synchronize()
    a_k, a_p = a_k.reshape(-1, out_len), a_p.reshape(-1, out_len)
    d = wrapped(a_k - a_p)
    err_max = float(d.max())
    err_p999 = float(torch.quantile(d.reshape(-1)[: 1 << 24].float(), 0.999))
    del d, a_p
    w64 = torch.as_tensor(np.ascontiguousarray(fe.taps_mod[..., ::-1]),
                          dtype=torch.complex128, device=x.device).reshape(-1, K)
    rot64 = torch.as_tensor(np.asarray(fe.rot).reshape(-1), dtype=torch.complex128,
                            device=x.device)
    oracle_err, c_last_rel = 0.0, 0.0
    for m0 in sorted({0, out_len // 2, max(out_len - 4096, 0)}):
        m1 = min(out_len, m0 + 4096)
        lo = max(m0 - 1, 0)
        win = samples(lo * J, (m1 - 1) * J + K).unfold(0, K, J)   # (m1 - lo, K)
        for ch in range(w64.shape[0]):
            c = win @ w64[ch]
            prev = torch.cat([c_prev[ch:ch + 1].to(torch.complex128), c[:-1]]) \
                if m0 == 0 else c[:-1]
            cur = c if m0 == 0 else c[1:]
            ref = torch.angle(cur * prev.conj() * rot64[ch])
            oracle_err = max(oracle_err, float(wrapped(a_k[ch, m0:m1] - ref).max()))
            if m1 == out_len:
                c_last_rel = max(c_last_rel, abs(complex((c_k[ch] - c[-1]).cpu()))
                                 / max(float(c.abs().max()), 1e-30))
    chans = a_k.shape[0]
    n_in = x.numel() * x.element_size()
    print(f"{label}: {'K1' if kind == 'u8' else 'K4'} J {J}, {chans} channel(s), "
          f"out_len {out_len}: vs plain max {err_max:.3e} p99.9 {err_p999:.3e}, vs "
          f"fp64 oracle max {oracle_err:.3e}, c_last vs c[out_len-1] "
          f"{c_last_rel:.3e} of max |c|", flush=True)
    print(f"{label}: {'K1' if kind == 'u8' else 'K4'} launch: "
          f"{plan_line(ddc, kind, chans, K, J, out_len, x.device)}", flush=True)
    check(err_p999 < PLAIN_P999_TOL and err_max < PLAIN_MAX_TOL,
          f"{label} vs plain p99.9 {err_p999} max {err_max}")
    check(oracle_err < (2e-4 if kind == "c64" else ORACLE_TOL),
          f"{label} vs fp64 oracle {oracle_err}")
    check(c_last_rel < 5e-6, f"{label} c_last {c_last_rel}")
    out = {"max_abs_err": err_max, "oracle_err": oracle_err,
           **ddc_bound(n_in, chans, out_len, K)}
    if not timed:
        return out
    del a_k
    xs = (samples(0, (out_len - 1) * J + K).to(torch.complex64) if kind == "u8"
          else x[: (out_len - 1) * J + K])
    out["library_ms"] = conv_library_ms(xs, taps_rev, J, reps)
    del xs
    out["ms"] = cuda_ms(kernel, reps)
    out["plain_ms"] = cuda_ms(lambda: plain(x, taps_rev, rot, c_prev, J, out_len),
                              plain_reps)
    print(f"{label}: {'K1' if kind == 'u8' else 'K4'} {out['ms']:.4f} ms, plain "
          f"{out['plain_ms']:.4f} ms, cuDNN conv1d {out['library_ms']:.4f} ms, bound "
          f"{out['bound_ms']:.4f} ms ({out['bound_by']}, {n_in / 1e6:.1f} MB in) on "
          f"{card_line()}", flush=True)
    return out


def phase14_k4(ddc, dev, blk: int = 20_000_000) -> dict:
    """K4 against its plain version and the fp64 oracle on a 20,000,000-sample
    complex64 block (as DdcFmStream hands a later block over: the history
    samples as `head=`, then the block) at J = 34 and J = 68, timed; at a ragged
    out_len; with three channels; and at J = 409 with K1 beside it. Returns
    the kernel-table numbers of K4 (J = 34) and the J = 409 results."""
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import design, resample as rs
    x = synth_fm(2 * blk, dev, seed=4, host=False)
    taps = design.blackmanharris(151)
    cp = torch.tensor([1.0 + 0.5j] * 3, dtype=torch.complex64, device=dev)
    res = {}
    for bw in (60_000, 30_000):
        fe = DdcFm(FS, FM_OFFSET_HZ, taps, bw)
        J, K = fe.stride, fe.ntaps
        off = rs.decim_phase(blk, J)
        out_len = rs.decim_count(blk, off, J)
        seg = x[blk - (K - 1) + off: 2 * blk].contiguous()
        res[J] = ddc_compare(ddc, "c64", seg, lambda a, b: seg[a:b].to(torch.complex128),
                             fe, cp[:1], out_len, f"phase 14 (J {J})", head=K - 1 - off)
    fe = DdcFm(FS, FM_OFFSET_HZ, taps, 60_000)
    ragged = min(100_003, (blk - 151) // 34 + 1 - 17)
    seg = x[: (ragged - 1) * 34 + 151]
    ddc_compare(ddc, "c64", seg, lambda a, b: seg[a:b].to(torch.complex128), fe,
                cp[:1], ragged, "phase 14 (ragged out_len)", timed=False)
    bank = MultiDdcFm(FS, NOAA_BANK_HZ, taps, 60_000)
    seg = synth_fm(blk + 150, dev, seed=7, host=False, offsets=NOAA_BANK_HZ)
    out_len = (seg.shape[0] - 151) // 34 + 1
    res["bank"] = ddc_compare(ddc, "c64", seg, lambda a, b: seg[a:b].to(torch.complex128),
                              bank, cp, out_len, "phase 14 (3 channels)", reps=10)
    _, taps_rev, rot, _ = bank.consts(dev)
    audio, c_last = ddc.ddc_fm_c64(seg, taps_rev, rot, cp, 34, out_len)
    for ch in range(3):
        a1, c1 = ddc.ddc_fm_c64(seg, taps_rev[ch].contiguous(), rot[ch:ch + 1].contiguous(),
                                cp[ch:ch + 1].contiguous(), 34, out_len)
        check(torch.equal(audio[ch], a1) and torch.equal(c_last[ch:ch + 1], c1),
              f"K4 channel {ch} equals its one-channel launch bit for bit")
    del audio, a1
    one = cuda_ms(lambda: [ddc.ddc_fm_c64(seg, taps_rev[ch].contiguous(), rot[ch:ch + 1],
                                          cp[ch:ch + 1], 34, out_len) for ch in range(3)], 10)
    print(f"phase 14: 3 channels in one K4 launch {res['bank']['ms']:.4f} ms, three "
          f"one-channel launches {one:.4f} ms; channels equal bit for bit", flush=True)
    # J = 409 (a 5 kHz -b): T drops to 64 to fit the shared memory
    fe = DdcFm(FS, FM_OFFSET_HZ, taps, 5_000)
    J, K = fe.stride, fe.ntaps
    check(J == 409, f"J {J} at 5 kHz")
    out_len = (blk - K) // J + 1
    seg = x[:blk]
    res["j409_k4"] = ddc_compare(ddc, "c64", seg, lambda a, b: seg[a:b].to(torch.complex128),
                                 fe, cp[:1], out_len, "phase 14 (J 409)", reps=5,
                                 plain_reps=2)
    raw = torch.view_as_real(seg).reshape(-1).add(127.5).round().clamp(0, 255) \
        .to(torch.uint8)
    del x
    res["j409_k1"] = ddc_compare(ddc, "u8", raw, u8_samples(raw), fe, cp[:1], out_len,
                                 "phase 14 (K1 at J 409)", reps=5, plain_reps=2)
    return res


def u8_samples(raw: torch.Tensor):
    """samples(lo, hi) of `ddc_compare` for raw interleaved uint8 IQ."""
    def samples(a, b):
        r = raw[2 * a: 2 * b].double() - 127.5
        return torch.complex(r[0::2], r[1::2])
    return samples


def phase15_fm(ddc, dev, seconds: float = 600.0) -> int:
    """A 10-minute complex64 FM capture (1,228,800,000 samples, 9.83 GB)
    synthesized on the card and held in host memory as an ArraySource,
    decoded with FmDecoder(offset 30 kHz, bw 30 kHz, audio 15 kHz), cold and
    then warm: the audio must correlate with the modulating audio at >= 0.99
    and K4 must run once a block. Returns the warm run's K4 launch count."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.io.sources import ArraySource
    from directdemod_tpu_torch.models.fm import FmDecoder
    from directdemod_tpu_torch.stream.plan import plan_blocks
    n = int(seconds * FS)
    t0 = time.perf_counter()
    x = synth_fm(n, dev, seed=5)
    print(f"phase 15: synthesized {n} complex64 samples ({x.nbytes / 1e9:.2f} GB, "
          f"host) in {time.perf_counter() - t0:.1f} s", flush=True)
    src = ArraySource(x, FS)
    blocks = len(plan_blocks(n, constants.PROC_CHUNKSIZE))
    for run in ("cold", "warm"):
        dec = FmDecoder(src, FM_OFFSET_HZ, bw=30_000, audio_freq=15_000, device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        ddc.LAUNCHES_C64 = 0
        t0 = time.perf_counter()
        audio, rate = dec.get_audio()
        wall = time.perf_counter() - t0
        launches = ddc.LAUNCHES_C64
        stages = {k: round(v, 4) for k, v in dec.stage_seconds.items()}
        times = fm_audio_times(n, 68, int(FS / 68), rate, constants.PROC_CHUNKSIZE)
        corr, lag = fm_correlation(audio, times, dev)
        print(f"phase 15 ({run}): FM decode of a {n / FS:.1f} s capture in {wall:.3f} "
              f"s wall ({n / FS / wall:.1f}x real time), stages (CUDA events) "
              f"{json.dumps(stages)}, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              f" GiB, {len(audio)} samples at {rate} Hz, correlation with the "
              f"modulating audio {corr:.6f} (lag {lag:.1f} us), K4 launches "
              f"{launches} of {blocks} blocks on {card_line()}", flush=True)
        check(rate == 15_000 and corr >= 0.99, f"FM audio correlation {corr}")
        check(launches == blocks, f"K4 launches {launches}, blocks {blocks}")
    return launches


def phase16_stream(ddc, dev, seconds: float = 120.0,
                   run_block: int = 1_000_000) -> tuple[int, int]:
    """The tutorial chains on a 2-minute complex64 FM capture (245,760,000
    samples, host): tutorial 3's chain (shift, FIR, bw_limit, fm_demod)
    through `run(block_size=1_000_000)` and `run_fused()`, tutorial 2's chain
    (a 400-4400 Hz Butterworth band-pass after the discriminator), a
    checkpoint after block 3 resumed in a fresh Pipeline (bit for bit), and
    a three-channel MultiDdcFm on the complex blocks against the
    one-channel front ends. Returns the K4 launches of run_fused and of the
    bank."""
    from directdemod_tpu_torch import constants as K
    from directdemod_tpu_torch.io.sources import ArraySource
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import filters
    from directdemod_tpu_torch.stream.api import Stream
    n = int(seconds * FS)
    x = synth_fm(n, dev, seed=6)
    src = ArraySource(x, FS)
    blocks = -(-n // K.PROC_CHUNKSIZE)

    def t3():
        return (Stream(src, device=dev).shift(FM_OFFSET_HZ)
                .filter(filters.blackman_harris(151)).bw_limit(60_000).fm_demod())
    t0 = time.perf_counter()
    small, rate = t3().run(block_size=run_block)
    t_run = time.perf_counter() - t0
    ddc.LAUNCHES_C64 = 0
    t0 = time.perf_counter()
    fused, rate_f = t3().run_fused()
    t_fused = time.perf_counter() - t0
    fused_launches = ddc.LAUNCHES_C64
    d = np.abs(np.angle(np.exp(1j * (small.astype(np.float64) - fused))))
    print(f"phase 16: tutorial 3 chain, run (1 M blocks) {t_run:.3f} s, run_fused "
          f"{t_fused:.3f} s ({fused_launches} K4 launches), {len(fused)} samples at "
          f"{rate_f} Hz; run vs run_fused max {d.max():.3e} p99.9 "
          f"{np.percentile(d, 99.9):.3e} rad", flush=True)
    check(rate == rate_f == 60_235 and small.shape == fused.shape
          and np.isfinite(fused).all(), "tutorial 3 outputs")
    check(np.percentile(d, 99.9) < PLAIN_P999_TOL and d.max() < PLAIN_MAX_TOL,
          "run and run_fused agree within the fp32 bars")
    check(fused_launches == blocks, f"run_fused launched K4 {fused_launches} times")
    del small, d

    def t2():
        return t3().filter(filters.butter(60_235, 400, 4400, kind=K.FLT_BP))
    t0 = time.perf_counter()
    full, rate2 = t2().run()
    print(f"phase 16: tutorial 2 chain (band-pass after the discriminator) "
          f"{time.perf_counter() - t0:.3f} s, {len(full)} samples at {rate2} Hz",
          flush=True)
    check(rate2 == 60_235 and full.shape == fused.shape and np.isfinite(full).all(),
          "tutorial 2 outputs")
    blk = K.PROC_CHUNKSIZE
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "t2.ckpt")
        first, _ = t2().build().process(ArraySource(x[: 4 * blk], FS),
                                        checkpoint_path=ck)
        rest, _ = t2().build().process(src, checkpoint_path=ck, resume=True)
    resumed = np.concatenate([first, rest])
    print(f"phase 16: checkpoint after block 3 (position {4 * blk}), resumed in a "
          f"fresh Pipeline: equal to the full run bit for bit: "
          f"{np.array_equal(resumed, full)}", flush=True)
    check(np.array_equal(resumed, full), "the resumed pipeline equals the full run")
    del full, first, rest, resumed

    freqs = (FM_OFFSET_HZ, -200_000, 350_000)
    taps = filters.blackman_harris(151)
    ddc.LAUNCHES_C64 = 0
    t0 = time.perf_counter()
    bank, _ = MultiDdcFm(FS, freqs, taps, 60_000).process(src, device=dev)
    t_bank = time.perf_counter() - t0
    bank_launches = ddc.LAUNCHES_C64
    t0 = time.perf_counter()
    ones = [DdcFm(FS, f, taps, 60_000).process(src, device=dev)[0] for f in freqs]
    t_ones = time.perf_counter() - t0
    # block 0's first outputs read each channel's own virtual history: the
    # bank takes them from a small conv, the one-channel stream from K4
    h = -(-150 // 34)
    same = all(np.array_equal(bank[ch, h:], ones[ch][h:]) for ch in range(3))
    head = max(float(np.abs(np.angle(np.exp(1j * (bank[ch, :h].astype(np.float64)
                                                   - ones[ch][:h])))).max())
               for ch in range(3))
    print(f"phase 16: complex MultiDdcFm, 3 channels in {t_bank:.3f} s ({bank_launches} "
          f"K4 launches), three one-channel runs {t_ones:.3f} s; channels equal the "
          f"one-channel front ends bit for bit after block 0's first {h} outputs: "
          f"{same}, those {head:.3e} rad apart", flush=True)
    check(same and head < 2e-4, "complex bank channels equal the one-channel streams")
    check(bank_launches == blocks, f"bank launched K4 {bank_launches} times")
    return fused_launches, bank_launches


def synth_noaa_bank_bytes(seconds: float, device, seed: int = 7,
                          chunk: int = 1 << 25) -> torch.Tensor:
    """A recording centred at 137.5 MHz holding three APT signals (NOAA-15,
    -18 and -19 at NOAA_BANK_HZ, the lines of `synth_pass_bytes`, a third
    of its amplitude each), quantized to uint8 IQ on `device`."""
    n_lines = int(seconds * 2)
    lines = np.stack([apt_line_words(np.linspace(30, 220, 1000) + 10 * (i % 3),
                                     np.linspace(220, 30, 1000))
                      for i in range(n_lines)])
    words = torch.as_tensor(lines.reshape(-1), dtype=torch.float64, device=device)
    n = int(seconds * FS)
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phase0 = torch.zeros(len(NOAA_BANK_HZ), dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.float64, device=device) / FS
        widx = torch.clamp((t * WORD_RATE).long(), max=words.shape[0] - 1)
        base = (0.05 + 0.9 * words[widx] / 255.0) * torch.cos(2 * np.pi * 2400.0 * t)
        sig = torch.zeros(e - s, dtype=torch.complex128, device=device)
        for i, f in enumerate(NOAA_BANK_HZ):
            dphi = 2 * np.pi * (f / FS) + 2 * np.pi * DEV_HZ * base / FS
            ph = phase0[i] + torch.cumsum(dphi, 0)
            phase0[i] = torch.remainder(ph[-1], 2 * np.pi)
            sig += torch.polar(torch.full_like(ph, 1 / 3), ph)
        for k, part in enumerate((sig.real, sig.imag)):
            noisy = part + 0.05 * torch.randn(e - s, dtype=torch.float64,
                                              device=device, generator=gen)
            out[2 * s + k: 2 * e: 2] = torch.clamp(
                torch.round(noisy * 90.0 + 127.5), 0, 255).to(torch.uint8)
    return out


def phase17_bank(ddc, dev, seconds: float = 600.0) -> tuple[int, dict, torch.Tensor]:
    """MultiDdcFm over a 10-minute uint8 capture holding NOAA-15, -18 and -19
    (2.46 GB on the card, a DeviceRawSource). First K1 with the bank's three
    channels (J = 34) against its plain version and the fp64 oracle on the
    capture's second 20,000,000-sample block, as the stream hands it over
    (the history samples as `head=`, then the block), timed. Then the bank's run: one
    K1 launch a block for the three channels, each equal bit for bit to the
    one-channel front end at its offset (the kernel's channel loop keeps
    each output's arithmetic), each carrying the 2,400 Hz APT subcarrier;
    wall time against three one-channel runs. Returns the bank's K1 launch
    count, the three-channel K1 comparison and the capture."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import design, resample as rs
    t0 = time.perf_counter()
    raw = synth_noaa_bank_bytes(seconds, dev)
    torch.cuda.synchronize()
    n = raw.shape[0] // 2
    print(f"phase 17: synthesized {n} samples ({raw.shape[0] / 1e9:.2f} GB) with "
          f"NOAA-15/18/19 at {NOAA_BANK_HZ} Hz in {time.perf_counter() - t0:.1f} s",
          flush=True)
    src = DeviceRawSource(raw, FS)
    taps = design.blackmanharris(151)
    blocks = -(-n // constants.PROC_CHUNKSIZE)
    bank = MultiDdcFm(FS, NOAA_BANK_HZ, taps, 60_000)
    blk, J, K = constants.PROC_CHUNKSIZE, bank.stride, bank.ntaps
    off = rs.decim_phase(blk, J)
    seg = raw[2 * (blk - (K - 1) + off): 2 * 2 * blk]
    cp = torch.tensor([1.0 + 0.5j] * 3, dtype=torch.complex64, device=dev)
    k1_bank = ddc_compare(ddc, "u8", seg, u8_samples(seg), bank, cp,
                          rs.decim_count(blk, off, J), "phase 17 (K1, 3 channels)",
                          reps=10, head=K - 1 - off)
    del seg
    for run in ("cold", "warm"):
        ddc.LAUNCHES = 0
        t0 = time.perf_counter()
        bank, rate = MultiDdcFm(FS, NOAA_BANK_HZ, taps, 60_000).process(src, device=dev)
        t_bank = time.perf_counter() - t0
        launches = ddc.LAUNCHES
        t0 = time.perf_counter()
        ones = [DdcFm(FS, f, taps, 60_000).process(src, device=dev)[0]
                for f in NOAA_BANK_HZ]
        t_ones = time.perf_counter() - t0
        same = all(np.array_equal(bank[ch], ones[ch]) for ch in range(3))
        peaks = []
        for ch in range(3):
            seg = bank[ch, len(bank[ch]) // 2:][: 1 << 20].astype(np.float64)
            spec = np.abs(np.fft.rfft(seg - seg.mean()))
            peaks.append(float(np.argmax(spec[1:]) + 1) * rate / len(seg))
        print(f"phase 17 ({run}): MultiDdcFm, 3 channels of a {n / FS:.1f} s capture "
              f"in {t_bank:.3f} s wall ({launches} K1 launches for {blocks} blocks), "
              f"three one-channel runs {t_ones:.3f} s; channels equal the one-channel "
              f"front ends bit for bit: {same}; strongest audio line per channel "
              f"{[round(p, 1) for p in peaks]} Hz on {card_line()}", flush=True)
        check(same and bank.shape[0] == 3, "bank channels equal the one-channel streams")
        check(all(abs(p - 2400.0) < 20 for p in peaks), f"APT subcarrier {peaks}")
        check(launches == blocks, f"K1 launches {launches}, blocks {blocks}")
    return launches, k1_bank, raw


# ------------------------------------------------------------- mesh slice
MESH_SHARDS = 4                 # one card named four times (three for the bank)


def card_mesh(dev, time: int = MESH_SHARDS, channel: int = 1):
    """A (time, channel) mesh whose every shard names the card: the shards
    run one after the other on it."""
    from directdemod_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(time=time, channel=channel, devices=[dev] * (time * channel))


def bit_diff(got: np.ndarray, ref: np.ndarray) -> tuple[int, float]:
    """(outputs whose bits differ, largest difference) of two equal-shape
    float arrays."""
    check(got.shape == ref.shape, f"shapes {got.shape} vs {ref.shape}")
    diff = got.view(np.uint32) != ref.view(np.uint32)
    return int(diff.sum()), float(np.abs(got.astype(np.float64) - ref).max(initial=0.0))


def phase18_sharded_bytes(ddc, fe, dev, raw: torch.Tensor, work: str
                          ) -> tuple[int, dict]:
    """(a) ShardedDdcFm over phase 4's 10-minute capture held on the card (a
    DeviceRawSource, its blocks sliced there) on a 4-shard `time` mesh,
    against DdcFm.process at the same 20,000,000-sample blocks: each shard
    runs K1 over its block with the previous block's last K-1+J samples as
    `head=`, one output more in front, so every output is the sequential
    stream's bit for bit. Then one such sharded K1 launch (the second block,
    its halo as the head) against its plain version and the fp64 oracle,
    timed. Keeps the sharded outputs in `work` for phase 25 (g). Returns the
    sharded run's K1 launches and that comparison."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.ops import resample as rs
    from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
    src = DeviceRawSource(raw, FS)
    blk = constants.PROC_CHUNKSIZE
    t0 = time.perf_counter()
    ref, _ = fe.process(src, blk, device=dev)
    t_seq = time.perf_counter() - t0
    sharded = ShardedDdcFm(fe, card_mesh(dev))
    ddc.LAUNCHES = 0
    t0 = time.perf_counter()
    got, _ = sharded.process(src, blk)
    t_sh = time.perf_counter() - t0
    launches = ddc.LAUNCHES
    n_diff, err = bit_diff(got, ref)
    print(f"phase 18 (a): ShardedDdcFm over {src.length} samples of bytes on the "
          f"card, {MESH_SHARDS} shards x {blk}-sample blocks: {launches} K1 "
          f"launches, {len(got)} outputs, {n_diff} not bit-equal to DdcFm.process "
          f"(largest difference {err:.3e}); wall {t_sh:.3f} s sharded, {t_seq:.3f} s "
          f"sequential on {card_line()}", flush=True)
    check(n_diff == 0, f"sharded front end over bytes: {n_diff} outputs differ")
    check(launches >= len(range(0, src.length, blk)), f"K1 launches {launches}")
    np.save(os.path.join(work, "g_ref.npy"), got)
    del got, ref
    J, K = fe.stride, fe.ntaps
    off = rs.decim_phase(blk, J)
    halo = sharded.halo
    seg = torch.cat([raw[2 * (blk - halo): 2 * blk].clone()[2 * off:],
                     raw[2 * blk: 4 * blk]])
    cp = torch.tensor([1.0 + 0.5j], dtype=torch.complex64, device=dev)
    k1 = ddc_compare(ddc, "u8", seg, u8_samples(seg), fe, cp,
                     rs.decim_count(blk, off, J) + 1, "phase 18 (a) (one sharded K1 launch)",
                     reps=10, plain_reps=2, head=halo - off)
    del seg
    k1["wall_s"], k1["seq_wall_s"] = t_sh, t_seq
    return launches, k1


def fm_chain(source, dev):
    """Tutorial 3's chain over `source`: shift, Blackman-Harris, 60 kHz,
    FM."""
    from directdemod_tpu_torch.ops import filters
    from directdemod_tpu_torch.stream.api import Stream
    return (Stream(source, device=dev).shift(FM_OFFSET_HZ)
            .filter(filters.blackman_harris(151)).bw_limit(60_000).fm_demod())


def phase19_run_sharded(ddc, dev, work: str, seconds: float = 120.0) -> int:
    """(b) Stream.run_sharded on a 4-shard mesh against run_fused, tutorial
    3's chain over phase 16's 2-minute complex64 FM capture (host): K4 a
    block, every output bit for bit. Keeps the capture and the outputs in
    `work` for phase 25 (h). Returns run_sharded's K4 launches."""
    from directdemod_tpu_torch.io.sources import ArraySource
    x = synth_fm(int(seconds * FS), dev, seed=6)
    chain = fm_chain(ArraySource(x, FS), dev)
    t0 = time.perf_counter()
    ref, rate = chain.run_fused()
    t_fused = time.perf_counter() - t0
    ddc.LAUNCHES_C64 = 0
    t0 = time.perf_counter()
    got, rate2 = chain.run_sharded(card_mesh(dev))
    t_sh = time.perf_counter() - t0
    launches = ddc.LAUNCHES_C64
    n_diff, err = bit_diff(got, ref)
    print(f"phase 19 (b): run_sharded over {len(x)} complex64 samples, "
          f"{MESH_SHARDS} shards: {launches} K4 launches, {n_diff} of {len(got)} "
          f"outputs not bit-equal to run_fused (largest difference {err:.3e}); wall "
          f"{t_sh:.3f} s, run_fused {t_fused:.3f} s on {card_line()}", flush=True)
    check(rate == rate2 and n_diff == 0, f"run_sharded vs run_fused: {n_diff} differ")
    check(launches == -(-len(x) // 20_000_000), f"K4 launches {launches}")
    np.save(os.path.join(work, "fm.npy"), x)
    np.save(os.path.join(work, "h_ref.npy"), got)
    return launches


def phase20_noaa_mesh(ddc, dev, raw: torch.Tensor, work: str) -> tuple[int, dict]:
    """(c) NoaaDecoder(mesh=) on phase 4's 10-minute capture, a 4-shard mesh,
    cold and then warm, against the unsharded decode: usefulness 1, crude
    syncs equal, >= 99 % of image pixels equal and the accurate syncs
    within one sample (D12). Keeps the capture as a .dat file and the mesh
    decode's results in `work` for phase 25 (i). Returns the warm run's K1
    launches and its stage seconds and wall."""
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    src = DeviceRawSource(raw, FS)
    seq = NoaaDecoder(src, OFFSET_HZ, device=dev)
    t0 = time.perf_counter()
    s_crude, s_img = seq.get_crude_sync(), seq.get_image()
    s_acc = seq.get_accurate_sync(use_norm_correlate=True)
    t_seq = time.perf_counter() - t0
    mesh = card_mesh(dev)
    for run in ("cold", "warm"):
        dec = NoaaDecoder(src, OFFSET_HZ, device=dev, mesh=mesh)
        ddc.LAUNCHES = 0
        t0 = time.perf_counter()
        useful = dec.useful
        crude = dec.get_crude_sync()
        img = dec.get_image()
        acc = dec.get_accurate_sync(use_norm_correlate=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ddc.LAUNCHES
        same_crude = all(np.array_equal(a, b) for a, b in zip(crude, s_crude))
        px = float(np.mean(img == s_img)) if img.shape == s_img.shape else 0.0
        acc_d = [int(np.max(np.abs(np.subtract(acc[c], s_acc[c])), initial=0))
                 if len(acc[c]) == len(s_acc[c]) else -1 for c in (0, 4)]
        stages = {k: round(v, 4) for k, v in dec.stage_seconds.items()}
        print(f"phase 20 (c) ({run}): NoaaDecoder on {MESH_SHARDS} shards, "
              f"{src.length / FS:.1f} s pass in {wall:.3f} s wall (unsharded "
              f"{t_seq:.3f} s), stages {json.dumps(stages)}, useful {useful}, "
              f"crude syncs equal {same_crude}, image {img.shape} {100 * px:.3f} % "
              f"of pixels equal, accurate syncs A/B within {acc_d} samples, K1 "
              f"launches {launches} on {card_line()}", flush=True)
        check(useful == 1 and same_crude, "mesh decode: useful, crude syncs equal")
        check(px >= 0.99, f"mesh decode image {px}")
        check(min(acc_d) >= 0 and max(acc_d) <= 1, f"accurate syncs {acc_d}")
        check(launches > 0, "the mesh decode launched K1")
    np.savez(os.path.join(work, "i_ref.npz"), sync_a=crude[0], sync_b=crude[1], image=img,
             acc_a=np.asarray(acc[0]), acc_b=np.asarray(acc[4]))
    raw.cpu().numpy().tofile(os.path.join(work, "noaa.dat"))
    return launches, {"wall_s": wall, "seq_wall_s": t_seq, "stages": stages}


def phase21_bank_mesh(ddc, dev, raw: torch.Tensor) -> int:
    """(d) MultiDdcFm over phase 17's NOAA-15/18/19 capture on a 1 x 3
    `channel` mesh of the card (a one-channel bank a shard, K1 a block on
    each), each channel bit for bit the unsharded bank's. Returns its K1
    launches."""
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import design
    src = DeviceRawSource(raw, FS)
    taps = design.blackmanharris(151)
    t0 = time.perf_counter()
    ref, _ = MultiDdcFm(FS, NOAA_BANK_HZ, taps, 60_000).process(src, device=dev)
    t_bank = time.perf_counter() - t0
    ddc.LAUNCHES = 0
    t0 = time.perf_counter()
    got, _ = MultiDdcFm(FS, NOAA_BANK_HZ, taps, 60_000,
                        mesh=card_mesh(dev, time=1, channel=3)).process(src)
    t_mesh = time.perf_counter() - t0
    launches = ddc.LAUNCHES
    n_diff, err = bit_diff(got, ref)
    blocks = -(-src.length // 20_000_000)
    print(f"phase 21 (d): MultiDdcFm on a 1 x 3 channel mesh, {launches} K1 "
          f"launches for {blocks} blocks, {n_diff} outputs not bit-equal to the "
          f"unsharded bank (largest difference {err:.3e}); wall {t_mesh:.3f} s, "
          f"unsharded {t_bank:.3f} s on {card_line()}", flush=True)
    check(n_diff == 0, f"channel mesh bank: {n_diff} outputs differ")
    check(launches == 3 * blocks, f"K1 launches {launches}")
    return launches


class ScanRecorder:
    """Within `with`, keeps on the host what every `pll.symbol_scan_segments`
    call returns (the symbols, their segments, the owned mask)."""

    def __enter__(self):
        from directdemod_tpu_torch.ops import pll
        self.pll, self.orig, self.calls = pll, pll.symbol_scan_segments, []

        def record(*a, **kw):
            out = self.orig(*a, **kw)
            self.calls.append([t.cpu() for t in out[0]] + [out[1].cpu(), out[2].cpu()])
            return out
        pll.symbol_scan_segments = record
        return self

    def __exit__(self, *exc):
        self.pll.symbol_scan_segments = self.orig


def phase22_psk_mesh(dev, fc_raw: torch.Tensor, mm_raw: torch.Tensor
                     ) -> tuple[int, int]:
    """(e) Funcube on phase 11's first 64 s and Meteor on phase 12's
    2-minute capture, 32 segments, with a 4-shard mesh and without one (both
    above the whole-capture limit, so both take the block loop): the same
    syncs, and K3's symbols of every block bit for bit (one K3 launch a
    shard over its 8 segments, against one over all 32). Returns the mesh
    decodes' K3 launches."""
    from directdemod_tpu_torch.models.funcube import FuncubeDecoder
    from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
    out = []
    for name, cls, raw, off in (("funcube", FuncubeDecoder, fc_raw, FC_OFFSET_HZ),
                                ("meteor", MeteorM2Decoder, mm_raw, MM_OFFSET_HZ)):
        runs = {}
        for label, mesh in (("no mesh", None), ("mesh", card_mesh(dev))):
            with ScanRecorder() as rec:
                syncs, dec, wall, launches = psk_decode(
                    cls, raw, off, dev, f"phase 22 (e) ({name}, 32 segments, {label})",
                    n_segments=32, mesh=mesh)
            runs[label] = (syncs, dec.useful, rec.calls, launches, wall)
        (s0, u0, c0, l0, _), (s1, u1, c1, l1, _) = runs["no mesh"], runs["mesh"]
        same = len(c0) == len(c1) and all(
            len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
            for a, b in zip(c0, c1))
        n_sym = sum(int(c[0].shape[0]) for c in c1)
        print(f"phase 22 (e) ({name}): syncs equal {s0 == s1} ({len(s1)}), K3 symbols "
              f"of {len(c1)} blocks ({n_sym} symbols) bit for bit {same}; K3 launches "
              f"{l1} on the mesh, {l0} without", flush=True)
        check(s0 == s1 and u0 == u1 == 1 and same, f"{name} on a mesh")
        check(l1 == MESH_SHARDS * l0, f"{name} K3 launches {l1} vs {l0}")
        out.append(l1)
    return out[0], out[1]


def phase23_dryrun(ddc, pll, dev) -> dict:
    """(f) parallel.dryrun(4) on four shards that name the card: every
    check passes. Returns its result with its K4 and K3 launches."""
    from directdemod_tpu_torch.parallel.dryrun import dryrun
    ddc.LAUNCHES_C64, pll.LAUNCHES = 0, 0
    t0 = time.perf_counter()
    res = dryrun(MESH_SHARDS, device=dev)
    res["wall_s"] = time.perf_counter() - t0
    res["k4_launches"], res["k3_launches"] = ddc.LAUNCHES_C64, pll.LAUNCHES
    print(f"phase 23 (f): dryrun({MESH_SHARDS}) {json.dumps(res)} on {card_line()}",
          flush=True)
    check(res["finite"] and res["k4_launches"] > 0 and res["k3_launches"] > 0,
          "dryrun ran K4 and K3")
    return res


def phase24_mesh_cli(dev) -> None:
    """The NOAA CLI with --map (no pyorbital on the machine: the log says so,
    the image is still written, no map file), with --map and the bundled
    TLE file, and with --mesh=2 on one card, which must exit non-zero with
    the mesh's device-count message, as the JAX CLI does."""
    raw, _ = synth_pass_bytes(60, dev, seed=2)
    name = "SDRSharp_20170830_073907Z_137590000Hz_IQ.wav"
    stem = name.split(".")[0]
    tle = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tle",
                       "noaa18_synthetic.txt")
    for extra in (["--map"], ["--map", f"--tle={tle}"]):
        _, ch, files, wall = run_cli(raw, name, ["-c", "137590000", "-f", "137620000",
                                                 "-d", "noaa", *extra],
                                     log_has="pyorbital not installed")
        check(stem + "_f1.png" in files and not any("_map" in f for f in files)
              and ch["usefulness"] == 1, f"--map files {sorted(files)}")
        print(f"phase 24: CLI {' '.join(e.split('=')[0] for e in extra)}: rc 0 in "
              f"{wall:.1f} s, 'pyorbital not installed' logged, files "
              f"{ch['filesCreated']}", flush=True)
    err = run_cli(raw, name, ["-c", "137590000", "-f", "137620000", "-d", "noaa",
                              "--mesh=2"], expect_ok=False)
    want = f"2x1 mesh needs 2 devices, have {torch.cuda.device_count()}"
    check(want in err, f"--mesh=2 message: {err[-300:]}")
    print(f"phase 24: CLI --mesh=2 on {torch.cuda.device_count()} card(s) exits "
          f"non-zero: ValueError: {want}", flush=True)


# ------------------------------------------------------------- processes
PROC_WORLD = 2                  # phase 25's processes, each owning two shards on the card
PROC_SHARDS = 2
WORKER_TIMEOUT_S = 600


def worker_source(work: str, dev, case: str):
    """Phase 25's input of `case` as a rank opens it, with its front end:
    the NOAA bytes as an IQDat and the NOAA front end for (g) and (i); the
    complex64 capture as an ArraySource over the memory-mapped file and
    tutorial 3's front end for (h) and (j)."""
    from directdemod_tpu_torch.io.sources import ArraySource, IQDat
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.ops import design
    if case in ("h", "j"):
        fm = ArraySource(np.load(os.path.join(work, "fm.npy"), mmap_mode="r"), FS)
        return fm, fm_chain(fm, dev)._as_ddc()
    return (IQDat(os.path.join(work, "noaa.dat"), FS),
            DdcFm(FS, OFFSET_HZ, design.blackmanharris(151), 60_000))


def sharded_run(case: str, src, fe, mesh, blk: int, dev) -> np.ndarray:
    """Phase 25's front end of `case` over `mesh`: ShardedDdcFm for (g) and
    (h), tutorial 3's chain through Stream.run_sharded for (j)."""
    from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
    if case == "j":
        return fm_chain(src, dev).run_sharded(mesh, blk)[0]
    return ShardedDdcFm(fe, mesh).process(src, blk)[0]


REF_OF = {"g": "g_ref.npy", "h": "h_ref.npy", "j": "h_ref.npy"}


def mesh_worker(rank: int, world: int, port: int, work: str, cases: str) -> None:
    """One rank of phase 25 (`chip_smoke.py --worker rank world port work
    cases`): joins the process group on localhost, takes PROC_SHARDS
    `time` shards that all name cuda:0 of a mesh over every rank, and runs
    `cases` on it, each rank reading only its own blocks: (g) ShardedDdcFm
    over the NOAA bytes (K1), (h) over the complex64 capture (K4), (j)
    Stream.run_sharded over the same capture, (i) NoaaDecoder(mesh=) cold
    and warm. Each output is held to the one-process results in `work`,
    bit for bit for (g), (h) and (j), by the JAX two-process test's bars
    on rank 0 for (i). Prints one line `WORKER {json}` a case."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    from directdemod_tpu_torch.ops import ddc
    from directdemod_tpu_torch.parallel import distributed
    from directdemod_tpu_torch.parallel.mesh import make_mesh
    dev = torch.device("cuda", 0)
    distributed.initialize(f"127.0.0.1:{port}", world, rank, local_devices=PROC_SHARDS,
                           device=dev)
    mesh = make_mesh(time=world * PROC_SHARDS)
    check(mesh.local_time == [rank * PROC_SHARDS + i for i in range(PROC_SHARDS)],
          f"rank {rank} owns {mesh.local_time}")
    ddc.build()
    with open(os.path.join(work, "spec.json")) as f:
        spec = json.load(f)
    for case in cases.split(","):
        res = {"case": case, "rank": rank, "shards": mesh.local_time}
        src, fe = worker_source(work, dev, case)
        if case in REF_OF:
            ddc.LAUNCHES = ddc.LAUNCHES_C64 = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = sharded_run(case, src, fe, mesh,
                              spec.get("block", constants.PROC_CHUNKSIZE), dev)
            res["wall_s"] = time.perf_counter() - t0
            res["launches"] = ddc.LAUNCHES if case == "g" else ddc.LAUNCHES_C64
            res["outputs"] = len(got)
            res["n_diff"], res["max_diff"] = bit_diff(
                got, np.load(os.path.join(work, REF_OF[case])))
        elif case == "i":
            ref = np.load(os.path.join(work, "i_ref.npz"))
            for run in ("cold", "warm"):
                dec = NoaaDecoder(src, OFFSET_HZ, device=dev, mesh=mesh)
                ddc.LAUNCHES = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                useful = dec.useful
                crude = dec.get_crude_sync()
                img = dec.get_image()
                acc = dec.get_accurate_sync(use_norm_correlate=True)
                torch.cuda.synchronize()
                res[f"{run}_wall_s"] = time.perf_counter() - t0
            res["launches"] = ddc.LAUNCHES
            res["stages"] = dec.stage_seconds
            res["useful"] = useful
            res["crude_equal"] = bool(np.array_equal(crude[0], ref["sync_a"])
                                      and np.array_equal(crude[1], ref["sync_b"]))
            same_shape = img.shape == ref["image"].shape
            res["pixels_equal"] = float(np.mean(img == ref["image"])) if same_shape else 0.0
            res["pixel_max_diff"] = (int(np.abs(img.astype(int) - ref["image"]).max())
                                     if same_shape else 256)
            res["acc_diff"] = [int(np.max(np.abs(np.subtract(acc[c], ref[k])), initial=0))
                               if len(acc[c]) == len(ref[k]) else -1
                               for c, k in ((0, "acc_a"), (4, "acc_b"))]
        print("WORKER " + json.dumps(res), flush=True)
    distributed.shutdown()


def phase25_two_processes(ddc, dev, work: str) -> dict:
    """(g)-(j) on a 4-shard `time` mesh over two processes, each owning two
    shards that name this card (`parallel.distributed` over gloo, started
    with `subprocess`): phase 18's bytes (K1), phase 19's complex64 capture
    (K4) through ShardedDdcFm and through Stream.run_sharded, and phase
    20's NOAA decode, each rank reading its own blocks from the files in
    `work`; the one-process mesh over the same files runs here first, for
    the wall. A rank that fails, or outlives WORKER_TIMEOUT_S, fails the
    phase. Returns the launches and walls."""
    from directdemod_tpu_torch import constants
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    from directdemod_tpu_torch.parallel import distributed
    blk = constants.PROC_CHUNKSIZE
    with open(os.path.join(work, "spec.json"), "w") as f:
        json.dump({"block": blk}, f)
    one = {}
    for case in REF_OF:
        src, fe = worker_source(work, dev, case)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sharded_run(case, src, fe, card_mesh(dev), blk, dev)
        one[case] = time.perf_counter() - t0
        n_diff, _ = bit_diff(got, np.load(os.path.join(work, REF_OF[case])))
        check(n_diff == 0, f"one-process mesh over the files ({case}): {n_diff} differ")
    noaa, _ = worker_source(work, dev, "i")
    dec = NoaaDecoder(noaa, OFFSET_HZ, device=dev, mesh=card_mesh(dev))
    t0 = time.perf_counter()
    dec.get_image()
    dec.get_accurate_sync(use_norm_correlate=True)
    torch.cuda.synchronize()
    one["i"] = time.perf_counter() - t0
    del got, dec
    torch.cuda.empty_cache()

    here = os.path.dirname(os.path.abspath(__file__))
    port = distributed.free_port()
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    runs = distributed.launch(
        [[os.path.abspath(__file__), "--worker", str(r), str(PROC_WORLD), str(port), work,
          "g,h,j,i"] for r in range(PROC_WORLD)], timeout_s=WORKER_TIMEOUT_S, env=env, cwd=work)
    t_launch = time.perf_counter() - t0
    res = {}
    for r, (code, text) in enumerate(runs):
        check(code == 0, f"phase 25 rank {r} exit {code}:\n{text[-4000:]}")
        for line in text.splitlines():
            if line.startswith("WORKER "):
                w = json.loads(line[len("WORKER "):])
                res[(w["case"], w["rank"])] = w
    check(len(res) == 4 * PROC_WORLD, f"phase 25 results {sorted(res)}")
    out = {"one_process_wall_s": one, "launch_wall_s": t_launch}
    checks = []                 # every case is printed before any check fails
    for case, kernel, api in (("g", "K1", "ShardedDdcFm"), ("h", "K4", "ShardedDdcFm"),
                              ("j", "K4", "Stream.run_sharded")):
        ranks = [res[(case, r)] for r in range(PROC_WORLD)]
        launches = [w["launches"] for w in ranks]
        blocks = -(-worker_source(work, dev, case)[0].length // blk)
        print(f"phase 25 ({case}): {api} on {PROC_WORLD} processes x {PROC_SHARDS} "
              f"shards of the card, {ranks[0]['outputs']} outputs on each rank, "
              f"{[w['n_diff'] for w in ranks]} not bit-equal to the one-process mesh; "
              f"{kernel} launches by rank {launches} (sum {sum(launches)}, {blocks} blocks); "
              f"wall by rank {[round(w['wall_s'], 3) for w in ranks]} s against "
              f"{one[case]:.3f} s in one process on {card_line()}", flush=True)
        checks += [(all(w["n_diff"] == 0 for w in ranks), f"({case}) outputs differ"),
                   (all(n > 0 for n in launches) and sum(launches) == blocks,
                    f"({case}) {kernel} launches {launches} for {blocks} blocks")]
        out[f"{case}_launches"] = sum(launches)
        out[f"{case}_wall_s"] = [w["wall_s"] for w in ranks]
    ranks = [res[("i", r)] for r in range(PROC_WORLD)]
    r0 = ranks[0]
    print(f"phase 25 (i): NoaaDecoder on {PROC_WORLD} processes x {PROC_SHARDS} shards: "
          f"rank 0 crude syncs equal {r0['crude_equal']}, {100 * r0['pixels_equal']:.3f} % "
          f"of pixels equal (largest difference {r0['pixel_max_diff']}), accurate syncs "
          f"A/B within {r0['acc_diff']} samples of the one-process mesh; warm wall by rank "
          f"{[round(w['warm_wall_s'], 3) for w in ranks]} s (cold "
          f"{[round(w['cold_wall_s'], 3) for w in ranks]}) against {one['i']:.3f} s in one "
          f"process; stages by rank "
          f"{[{k: round(v, 4) for k, v in w['stages'].items()} for w in ranks]}; K1 "
          f"launches by rank {[w['launches'] for w in ranks]} on {card_line()}", flush=True)
    checks += [(all(w["useful"] == 1 for w in ranks) and r0["crude_equal"],
                "two-process NOAA: useful, crude syncs equal"),
               (r0["pixels_equal"] >= 0.999 and r0["pixel_max_diff"] <= 1,
                f"two-process NOAA image {r0['pixels_equal']} {r0['pixel_max_diff']}"),
               (min(r0["acc_diff"]) >= 0 and max(r0["acc_diff"]) <= 1,
                f"two-process NOAA accurate syncs {r0['acc_diff']}"),
               (all(w["launches"] > 0 for w in ranks), "every rank launched K1 in the decode")]
    for cond, what in checks:
        check(cond, what)
    out["i_launches"] = sum(w["launches"] for w in ranks)
    out["i_wall_s"] = [w["warm_wall_s"] for w in ranks]
    return out


# ------------------------------------------------------------- peak variants
PEAK_PHASE = 1.0                # rad: the tones' first zero crossing lies inside them
PEAK_LOOKAHEAD = 500            # peaks_fft's lookahead
# (name, samples, samples a period, noise sigma, seed, position bar in input
# samples (None: in interpolated grid steps, PEAK_GRID_STEPS), value bar)
PEAK_TONES = (("A", 1 << 20, 64, 0.01, 0, 4.0, 0.05),
              ("B", 1 << 18, 2048, 0.0, 0, None, 1e-3))
# a float32 walk cannot tell apart the samples of (B)'s peak plateau, those
# within 2^-24 of +/-1: +/-4.1 grid steps at 2,048 samples a period, 32x
PEAK_GRID_STEPS = 5
PEAK_PREFIX = 1 << 16           # the card-vs-CPU comparison of the refinements
# the CPU tests' tolerances (tests/test_torch_peaks_extra.py)
PEAK_REFINE_TOL = {"peaks_parabola": 1e-9, "peaks_sine": 1e-9,
                   "peaks_sine_locked": 1e-9, "peaks_spline": 1e-8}


def peak_tone(n: int, period: int, noise: float, seed: int):
    """(x, y): the sample index and sin(2 pi x / period + PEAK_PHASE) plus
    white noise of sigma `noise` from numpy seed `seed`, float64 on the
    host."""
    x = np.arange(n, dtype=np.float64)
    y = np.sin(2 * np.pi * x / period + PEAK_PHASE)
    if noise:
        y = y + noise * np.random.default_rng(seed).standard_normal(n)
    return x, y


def tone_peak_errors(found: list, period: int, sign: int, lo: float, hi: float) -> dict:
    """`found` ([[x, value], ...] maxima for sign 1, minima for -1) against
    the tone's true extrema: the largest position and value errors, the
    extrema in (lo, hi - period / 2) that no peak found, the peaks that
    match no extremum in (lo, hi) or share one."""
    t0 = ((np.pi / 2 if sign > 0 else 1.5 * np.pi) - PEAK_PHASE) / (2 * np.pi) * period
    pos = np.asarray([p[0] for p in found], np.float64)
    val = np.asarray([p[1] for p in found], np.float64)
    k = np.round((pos - t0) / period)
    truth = np.arange(np.ceil((lo - t0) / period), np.floor((hi - t0) / period) + 1)
    need = truth[t0 + truth * period < hi - period / 2]
    return {"peaks": len(found),
            "pos_err": float(np.abs(pos - (t0 + k * period)).max()),
            "val_err": float(np.abs(val - sign).max()),
            "missing": int(np.setdiff1d(need, k).size),
            "extra": int(np.setdiff1d(k, truth).size + len(k) - len(np.unique(k)))}


def peaks_fft_walk(peaks, px, name: str, n: int, period: int, noise: float, seed: int,
                   pos_bar, val_bar, dev) -> tuple[int, dict]:
    """peaks_fft on one tone on the card (its K2 launches counted), held to
    the analytic extrema; K2 against its plain version on the first 2^22
    samples of the interpolated walk; the walk's parts timed. Returns
    (peaks_fft's K2 launches, the numbers)."""
    x, y = peak_tone(n, period, noise, seed)
    torch.cuda.synchronize()
    peaks.LAUNCHES = 0
    t0 = time.perf_counter()
    mx, mn = px.peaks_fft(y, x, device=dev)
    wall = time.perf_counter() - t0
    launches = peaks.LAUNCHES

    yi, xi, delta = px._fft_waveform(y, x, 20, dev)
    step = float(xi[1] - xi[0])
    bar = pos_bar if pos_bar is not None else PEAK_GRID_STEPS * step
    errs = [tone_peak_errors(f, period, sign, float(xi[0]), float(xi[-1]))
            for f, sign in ((mx, 1), (mn, -1))]
    label = f"phase 26 ({name})"
    print(f"{label}: peaks_fft on {n} samples ({period} a period, noise {noise}): "
          f"{yi.shape[0]} interpolated samples walked at lookahead {PEAK_LOOKAHEAD}, "
          f"delta {delta:.6f}, {launches} K2 launch(es), {wall:.3f} s wall; maxima "
          f"{json.dumps(errs[0])}, minima {json.dumps(errs[1])} (position bar {bar:.5f} "
          f"samples, grid step {step:.5f}; value bar {val_bar})", flush=True)
    check(launches == 1, f"{label}: peaks_fft launched K2 {launches} times")
    for e in errs:
        check(e["missing"] == 0 and e["extra"] == 0 and e["peaks"] > 0,
              f"{label}: one peak a period {e}")
        check(e["pos_err"] <= bar and e["val_err"] <= val_bar, f"{label}: peak errors {e}")

    # the walk's parts on the card
    y32 = yi.float().contiguous()
    limit = y32.shape[0] - PEAK_LOOKAHEAD
    fwe_ms = cuda_ms(lambda: peaks.forward_window_extrema(y32, PEAK_LOOKAHEAD), 3)
    fmax, fmin = peaks.forward_window_extrema(y32, PEAK_LOOKAHEAD)
    args = (y32[:limit], fmax[:limit].contiguous(), fmin[:limit].contiguous(), delta)
    stats = {}
    events = peaks.lookahead_walk(*args, stats=stats)[0].shape[0]
    steps = stats["stitch_steps"].double()
    walk_ms = cuda_ms(lambda: peaks.lookahead_walk(*args), 3)
    one_ms = cuda_ms(lambda: peaks.lookahead_walk(*args, chunk=limit), 1)
    step_ns = one_ms * 1e6 / limit
    out = {"walk_samples": limit, "events": events, "walk_ms": walk_ms,
           "forward_extrema_ms": fwe_ms, "wall_s": wall, "chunk": stats["chunk"],
           "chunks": stats["chunks"], "stitch_steps_max": int(steps.max()),
           "stitch_steps_mean": float(steps.mean()),
           "unmet_chunks": int((~stats["met"]).sum()), "one_walker_ms": one_ms,
           "chain_bound_ms": (stats["chunk"] + float(steps.sum())) * step_ns * 1e-6,
           **bound(12 * limit + 21 * events + 8, 6 * limit),
           "maxima": errs[0], "minima": errs[1]}
    del fmax, fmin, args
    print(f"{label}: K2 over the whole walk ({limit} samples, {events} events) "
          f"{walk_ms:.4f} ms, forward-window extrema (max pools of {PEAK_LOOKAHEAD}) "
          f"{fwe_ms:.4f} ms; {out['chunks']} chunks of {out['chunk']}, stitch "
          f"{out['stitch_steps_mean']:.1f} steps a chunk (largest {out['stitch_steps_max']}), "
          f"{out['unmet_chunks']} chunks that never met a speculative walk; one walker "
          f"{one_ms:.4f} ms ({step_ns:.2f} ns a step), chain bound "
          f"{out['chain_bound_ms']:.4f} ms, bound {out['bound_ms']:.5f} ms "
          f"({out['bound_by']}) on {card_line()}", flush=True)
    cmp = k2_compare(peaks, y32[: (1 << 22) + PEAK_LOOKAHEAD], PEAK_LOOKAHEAD, delta,
                     f"{label} first 2^22 samples of the walk", 1)
    out.update({f"{f}_2p22": cmp[f] for f in ("ms", "plain_ms", "bound_ms", "max_abs_err")})
    return launches, out


def phase26_peaks(peaks, dev) -> tuple[int, dict]:
    """The peak variants on the card: peaks_fft on tones (A) and (B)
    (`peaks_fft_walk`), then peaks_parabola, peaks_sine, peaks_sine_locked
    and peaks_spline on (A), timed, and on its first PEAK_PREFIX samples
    against the same functions on the CPU within the CPU tests'
    tolerances. Returns peaks_fft's K2 launches and the numbers."""
    from directdemod_tpu_torch.ops import peaks_extra as px
    launches, out = 0, {}
    for name, n, period, noise, seed, pos_bar, val_bar in PEAK_TONES:
        k, out[name] = peaks_fft_walk(peaks, px, name, n, period, noise, seed, pos_bar,
                                      val_bar, dev)
        launches += k
    name, n, period, noise, seed = PEAK_TONES[0][:5]
    x, y = peak_tone(n, period, noise, seed)
    for fn, tol in PEAK_REFINE_TOL.items():
        f = getattr(px, fn)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = f(y, x, device=dev)
        wall = time.perf_counter() - t0
        finite = all(np.isfinite(np.asarray(p, np.float64)).all() for p in got)
        card = f(y[:PEAK_PREFIX], x[:PEAK_PREFIX], device=dev)
        cpu = f(y[:PEAK_PREFIX], x[:PEAK_PREFIX], device="cpu")
        same = all(len(a) == len(b) for a, b in zip(card, cpu))
        err = max(float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())
                  for a, b in zip(card, cpu)) if same else float("inf")
        dev_pos = max(tone_peak_errors(p, period, sign, 0.0, float(n))["pos_err"]
                      for p, sign in zip(got, (1, -1)))
        out[fn] = {"wall_s": wall, "peaks": [len(p) for p in got], "card_vs_cpu": err,
                   "pos_err": dev_pos}
        print(f"phase 26 (A): {fn} on {n} samples {wall:.3f} s wall, {out[fn]['peaks']} "
              f"peaks, largest distance from the true extrema {dev_pos:.4f} samples; on the "
              f"first {PEAK_PREFIX} samples card vs CPU {err:.3e} (bar {tol}) on "
              f"{card_line()}", flush=True)
        check(finite and min(out[fn]["peaks"]) > 0, f"{fn}: finite peaks")
        check(err <= tol, f"{fn}: card vs CPU {err}")
    return launches, out


def two_process_smoke(n_lines: int = 240, fm_seconds: float = 60.0) -> dict:
    """Phases 18-20 and 25 alone on shorter captures (a 2-minute NOAA pass,
    a minute of FM: one wave and the blocks after it): the two-process mesh against the one-process one, for
    iterating on `parallel/` without the phases before them. Run it on the
    card as `python3 -c "import chip_smoke as s; s.two_process_smoke()"`."""
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.ops import ddc, design
    check(torch.cuda.is_available(), "a CUDA device")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    ddc.build()
    fe = DdcFm(FS, OFFSET_HZ, design.blackmanharris(151), 60_000)
    raw, _ = synth_pass_bytes(n_lines, dev, seed=1)
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        phase18_sharded_bytes(ddc, fe, dev, raw, work)
        phase19_run_sharded(ddc, dev, work, seconds=fm_seconds)
        phase20_noaa_mesh(ddc, dev, raw, work)
        del raw
        out = phase25_two_processes(ddc, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"two_process": out}), flush=True)
    return out


def peaks_smoke() -> dict:
    """Phase 26 alone (K2 built, then the peak variants), for iterating on
    `ops/peaks_extra` or K2 without the decodes. Run it on the card as
    `python3 -c "import chip_smoke as s; s.peaks_smoke()"`."""
    from directdemod_tpu_torch.ops import peaks
    check(torch.cuda.is_available(), "a CUDA device")
    print(card_line(), flush=True)
    peaks.build()
    launches, out = phase26_peaks(peaks, torch.device("cuda", 0))
    print(json.dumps({"peaks_fft_launches": launches, "peaks": out}), flush=True)
    return out


def k1k4_times(label: str = "k1k4") -> dict:
    """K1 and K4 alone on the main shapes, for iterating on their tile
    without the decodes: phase 3's and phase 6's K1 compares (J = 34 and
    92), phase 14 (K4 at J = 34, 68, ragged, 3 channels, J = 409 with K1)
    and phase 17's three-channel K1 compare on a 21-second bank capture.
    Each against its plain version and the fp64 oracle, with the launch
    plan and the times; returns the kernel-table numbers by shape and
    prints them as one JSON line. Run it on the card as
    `python3 -c "import chip_smoke as s; s.k1k4_times()"`."""
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import ddc, design, resample as rs
    check(torch.cuda.is_available(), "a CUDA device")
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    ddc.build()
    taps = design.blackmanharris(151)
    raw, _ = synth_pass_bytes(80, dev, seed=1)
    out = {"k1_34": k1_compare(ddc, DdcFm(FS, OFFSET_HZ, taps, 60_000), dev, raw,
                               f"{label} phase 3")}
    raw, _ = synth_aprs_bytes(41.0, dev, seed=1)
    out["k1_92"] = k1_compare(ddc, DdcFm(FS, APRS_OFFSET_HZ, taps, 22_050), dev, raw,
                              f"{label} phase 6")
    del raw
    out.update({f"k4_{k}": v for k, v in phase14_k4(ddc, dev).items()})
    raw = synth_noaa_bank_bytes(21.0, dev)
    bank = MultiDdcFm(FS, NOAA_BANK_HZ, taps, 60_000)
    blk, J, K = 20_000_000, bank.stride, bank.ntaps
    off = rs.decim_phase(blk, J)
    seg = raw[2 * (blk - (K - 1) + off): 2 * 2 * blk]
    cp = torch.tensor([1.0 + 0.5j] * 3, dtype=torch.complex64, device=dev)
    out["k1_3ch"] = ddc_compare(ddc, "u8", seg, u8_samples(seg), bank, cp,
                                rs.decim_count(blk, off, J), f"{label} phase 17 (K1, 3 ch)",
                                reps=10, head=K - 1 - off)
    print(json.dumps({label: {k: {f: v.get(f) for f in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "max_abs_err")}
                              for k, v in out.items()}}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(card_line(), flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.ops import _build, ddc, design, peaks, pll
    t0 = time.perf_counter()
    _build.build_all(["ddc_fm_u8", "ddc_fm_c64", "lookahead_walk", "symbol_scan",
                      ("symbol_scan", pll.STAGE_CLOCK_FLAGS)])
    ddc.build()
    peaks.build()
    pll.build()
    print(f"phase 2: K1, K4, K2 and K3 (and K3's measurement build) built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    fe = DdcFm(FS, OFFSET_HZ, design.blackmanharris(151), 60_000)
    raw, _ = synth_pass_bytes(80, dev, seed=1)
    k1 = k1_compare(ddc, fe, dev, raw, "phase 3")
    del raw
    noaa_k1, noaa_raw = phase4_decode(ddc, fe, dev)
    phase5_cli(dev)

    fe92 = DdcFm(FS, APRS_OFFSET_HZ, design.blackmanharris(151), 22_050)
    raw, _ = synth_aprs_bytes(41.0, dev, seed=1)
    k1_92 = k1_compare(ddc, fe92, dev, raw, "phase 6")
    del raw
    stress = [k2_compare(peaks, stress_edges(200_000, seed, dev), 11, delta,
                         "phase 7", 3) for seed, delta in ((0, 0.0), (1, 0.1))]
    afsk_k1, afsk_k2, k2 = phase8_afsk_decode(ddc, peaks, dev)
    phase9_afsk_cli(dev)

    streams = k3_streams(12_000_000)
    k3 = {f"{kind}_{segs}": k3_compare(pll, kind, streams[kind], dev, segs)
          for kind in ("bpsk", "qpsk") for segs in (1, 8)}
    del streams
    fc_k3, fc_raw = phase11_funcube(dev)
    mm_k3, mm_raw = phase12_meteor(dev)
    phase13_psk_cli(dev)

    k4 = phase14_k4(ddc, dev)
    fm_k4 = phase15_fm(ddc, dev)
    fused_k4, bank_k4 = phase16_stream(ddc, dev)
    bank_k1, k1_3ch, bank_raw = phase17_bank(ddc, dev)

    # the mesh slice, every shard on this card; `work` keeps phase 25's
    # inputs and the one-process results it is held to
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        sharded_k1, k1_mesh = phase18_sharded_bytes(ddc, fe, dev, noaa_raw, work)
        sharded_k4 = phase19_run_sharded(ddc, dev, work)
        noaa_mesh_k1, _ = phase20_noaa_mesh(ddc, dev, noaa_raw, work)
        del noaa_raw
        bank_mesh_k1 = phase21_bank_mesh(ddc, dev, bank_raw)
        del bank_raw
        fc_mesh_k3, mm_mesh_k3 = phase22_psk_mesh(dev, fc_raw, mm_raw)
        del fc_raw, mm_raw
        dry = phase23_dryrun(ddc, pll, dev)
        phase24_mesh_cli(dev)
        procs = phase25_two_processes(ddc, dev, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    fft_k2, peak_runs = phase26_peaks(peaks, dev)

    print(json.dumps({"kernels": [
        {"name": "ddc_fm_u8", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/ddc_fm_u8.cu",
         "replaces": "directdemod_tpu/ops/pallas_ddc.py:148",
         "launches": (noaa_k1 + afsk_k1 + bank_k1 + sharded_k1 + noaa_mesh_k1 + bank_mesh_k1
                      + procs["g_launches"] + procs["i_launches"]),
         "launches_by_path": {"noaa": noaa_k1, "afsk1200": afsk_k1,
                              "multichannel": bank_k1, "sharded_frontend": sharded_k1,
                              "noaa_mesh": noaa_mesh_k1, "multichannel_mesh": bank_mesh_k1,
                              "sharded_frontend_2proc": procs["g_launches"],
                              "noaa_mesh_2proc": procs["i_launches"]},
         **k1, "max_abs_err": max(k1["max_abs_err"], k1_92["max_abs_err"],
                                  k4["j409_k1"]["max_abs_err"], k1_3ch["max_abs_err"],
                                  k1_mesh["max_abs_err"]),
         **{f"{f}_sharded": k1_mesh[f] for f in ("ms", "plain_ms", "library_ms",
                                                 "bound_ms", "max_abs_err")},
         "ms_j92": k1_92["ms"], "plain_ms_j92": k1_92["plain_ms"],
         "library_ms_j92": k1_92["library_ms"], "bound_ms_j92": k1_92["bound_ms"],
         **{f"{f}_3ch": k1_3ch[f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                            "oracle_err")},
         "ms_j409": k4["j409_k1"]["ms"], "plain_ms_j409": k4["j409_k1"]["plain_ms"]},
        {"name": "ddc_fm_c64", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/ddc_fm_c64.cu",
         "replaces": "directdemod_tpu/ops/pallas_ddc.py:31",
         "launches": (fm_k4 + fused_k4 + bank_k4 + sharded_k4 + dry["k4_launches"]
                      + procs["h_launches"] + procs["j_launches"]),
         "launches_by_path": {"fm": fm_k4, "stream_fused": fused_k4,
                              "multichannel": bank_k4, "stream_sharded": sharded_k4,
                              "dryrun": dry["k4_launches"],
                              "stream_sharded_2proc": procs["h_launches"],
                              "stream_sharded_2proc_api": procs["j_launches"]},
         **{f: k4[34][f] for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                   "bound_by")},
         "max_abs_err": max(v["max_abs_err"] for key, v in k4.items()
                            if key != "j409_k1"),
         "oracle_err": max(v["oracle_err"] for key, v in k4.items()
                           if key != "j409_k1"),
         **{f"{f}_j68": k4[68][f] for f in ("ms", "plain_ms", "library_ms", "bound_ms")},
         **{f"{f}_3ch": k4["bank"][f] for f in ("ms", "plain_ms", "library_ms",
                                                "bound_ms")},
         "ms_j409": k4["j409_k4"]["ms"], "plain_ms_j409": k4["j409_k4"]["plain_ms"]},
        {"name": "lookahead_walk", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/lookahead_walk.cu",
         "replaces": "directdemod_tpu/ops/peaks.py:205",
         "launches": afsk_k2 + fft_k2,
         "launches_by_path": {"afsk1200": afsk_k2, "peaks_fft": fft_k2},
         **k2, "max_abs_err": max([k2["max_abs_err"]]
                                  + [s["max_abs_err"] for s in stress]
                                  + [peak_runs[t[0]]["max_abs_err_2p22"]
                                     for t in PEAK_TONES]),
         "peaks_fft": {t[0]: {k: v for k, v in peak_runs[t[0]].items()
                              if k not in ("maxima", "minima")} for t in PEAK_TONES},
         "stress_ms": [s["ms"] for s in stress],
         "stress_plain_ms": [s["plain_ms"] for s in stress]},
        {"name": "symbol_scan", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/symbol_scan.cu",
         "replaces": "directdemod_tpu/ops/pll_scalar.py:67",
         "launches": fc_k3 + mm_k3 + fc_mesh_k3 + mm_mesh_k3 + dry["k3_launches"],
         "launches_by_path": {"funcube": fc_k3, "meteor": mm_k3,
                              "funcube_mesh": fc_mesh_k3, "meteor_mesh": mm_mesh_k3,
                              "dryrun": dry["k3_launches"]},
         "max_abs_err": max(v["max_abs_err"] for v in k3.values()),
         **{f: k3["bpsk_1"][f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "chain_bound_ms")},
         "library_ms": None,
         **{f"{kind}_stage_cycles": {k: k3[f"{kind}_1"][k]
                                     for k in ("P", "C", "M", "wall", "P_reads")}
            for kind in ("bpsk", "qpsk")},
         "qpsk_1_chain_bound_ms": k3["qpsk_1"]["chain_bound_ms"],
         **{f"{key}_{f}": v[f] for key, v in k3.items()
            for f in ("ms", "plain_ms", "symbols", "bound_ms")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        rank, world, port, work, cases = sys.argv[2:7]
        mesh_worker(int(rank), int(world), int(port), work, cases)
        sys.exit(0)
    sys.exit(main())
