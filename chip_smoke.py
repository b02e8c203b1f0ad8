#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's four decode paths, NOAA APT, AFSK1200/APRS, Funcube BPSK
and Meteor-M2 QPSK, on the card and fails (non-zero exit, no result line)
on any error. Phases, in order:

1. check that a CUDA device exists and print its name and power limit;
2. build the CUDA kernels K1 (`csrc/ddc_fm_u8.cu`), K2
   (`csrc/lookahead_walk.cu`) and K3 (`csrc/symbol_scan.cu`) from the
   checkout, all compilers at once;
3. hold K1 against its plain PyTorch version and an fp64 oracle at the
   NOAA path's block shape (J=34, K=151, one 20,000,000-sample block plus
   its history) and time both with CUDA events;
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
   first 2^21 samples of that decode's own edge strength;
9. run the command-line interface on a 30-second APRS IQ.wav;
10. hold K3 against its plain version on 12,000,000-sample BPSK and QPSK
    streams, sequential and with 8 segments: symbol indices, minsync flags
    and needle choices equal, the largest phase difference printed; time
    K3 with CUDA events;
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
14. print the kernel table as one JSON line, then the result line
    {"ok": true, "device": {...}} last.

Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
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
    check(err_p999 < PLAIN_P999_TOL and err_max < PLAIN_MAX_TOL,
          f"K1 vs plain p99.9 {err_p999} max {err_max}")
    check(oracle_err < ORACLE_TOL, f"K1 vs fp64 oracle {oracle_err}")
    check(c_last_err < 1e-5 * max(c_last_scale, 1.0) + 1e-2,
          f"c_last error {c_last_err}")

    ms_k = cuda_ms(lambda: ddc.ddc_fm_u8(seg, taps_rev, rot, c_prev, J, out_len), 20)
    ms_p = cuda_ms(lambda: ddc.ddc_fm_u8_plain(seg, taps_rev, rot, c_prev, J,
                                               out_len), 5)
    print(f"{label}: K1 at J {J} {ms_k:.4f} ms, plain {ms_p:.4f} ms per "
          f"{blk}-sample block ({blk / ms_k / 1e6:.2f} Gsamp/s kernel, "
          f"{blk / ms_p / 1e6:.2f} Gsamp/s plain) on {card_line()}", flush=True)
    return {"max_abs_err": err_max, "ms": ms_k, "plain_ms": ms_p}


def phase4_decode(ddc, fe, dev) -> int:
    """Synthesize a 10-minute pass on the card and decode it from the bytes
    held there, twice: a cold run (first use of cuFFT plans, cuDNN and the
    allocator in this process) and a warm one. Then hold K1 against its
    plain version at the shape the decode gave it. Returns the warm run's
    K1 launch count."""
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
    return launches


def write_iq_wav(path: str, raw: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(raw)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 2, FS, FS * 2, 2, 8))
        f.write(b"data")
        f.write(struct.pack("<I", len(raw)))
        f.write(raw.tobytes())


def run_cli(raw: torch.Tensor, name: str, args: list):
    """Write `raw` as the IQ.wav `name` into a temporary directory and run
    the port's CLI there on it with `args` and `-r rep.json`. Fails unless
    it exits 0; returns (stdout, the report's first channel, the files the
    run left, wall seconds)."""
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
        check(proc.returncode == 0, f"CLI exit code {proc.returncode}")
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
    for f in (stem + "_f1.png", stem + "_f1.csv"):
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
    print(f"{label}: K2 over {limit} samples, lookahead {lookahead}, delta "
          f"{delta}: {ev_k[0].shape[0]} events, {mismatched} mismatched vs "
          f"plain (max field difference {err}); K2 {ms_k:.4f} ms "
          f"({ms_k * 1e6 / limit:.2f} ns per sample), plain {ms_p:.4f} ms "
          f"on {card_line()}", flush=True)
    check(err == 0.0 and ev_k[0].shape[0] > 0,
          f"K2 events equal the plain version's ({mismatched} mismatched)")
    return {"max_abs_err": err, "ms": ms_k, "plain_ms": ms_p}


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
    2^21 samples of that decode's own edge strength, and time K2 over the
    whole of it. Returns the warm run's K1 and K2 launch counts and the K2
    numbers."""
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
    k2 = k2_compare(peaks, edges[: (1 << 21) + lookahead], lookahead, 0.0,
                    "phase 8 (decode's edges, first 2^21 samples)", 1)
    limit = edges.shape[0] - lookahead
    fmax, fmin = peaks.forward_window_extrema(edges, lookahead)
    args = (edges[:limit], fmax[:limit].contiguous(), fmin[:limit].contiguous(), 0.0)
    k2["full_ms"] = cuda_ms(lambda: peaks.lookahead_walk(*args), 3)
    print(f"phase 8: K2 over the decode's whole edge strength ({limit} "
          f"samples) {k2['full_ms']:.4f} ms ({k2['full_ms'] * 1e6 / limit:.2f} "
          f"ns per sample) on {card_line()}", flush=True)
    return launches[0], launches[1], k2


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
    thread) or `segments` segments (one launch, a thread each). Symbol
    indices, minsync flags and needle choices must be equal; prints the
    largest phase difference. Times K3 with CUDA events and the plain
    version with the host clock (one run)."""
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
    print(f"phase 10 ({kind}, {segments} segment(s)): K3 over {len(x)} samples, "
          f"{got.count} symbols ({int(got.minsync.sum())} minsync): a_idx, "
          f"minsync, chosen equal to the plain version: {same}; largest phase "
          f"difference {err:.3e} rad; K3 {ms:.4f} ms ({ms * 1e6 / got.count:.1f} ns "
          f"a symbol), plain {plain_ms:.1f} ms on {card_line()}", flush=True)
    check(same and got.count > 0, f"K3 {kind} equals its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "symbols": got.count}


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


def phase11_funcube(dev) -> int:
    """A 10-minute Funcube capture synthesized on the card and decoded from
    the bytes held there, sequential, cold and then warm (the block loop,
    K3 once a block with the state carried); every planted frame after the
    first must come back at FC_SYNC_DELAY. Then the first 60 s with 32
    segments on the whole-capture path against the sequential decode of
    the same 60 s. Returns the warm run's K3 launch count."""
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
    return launches


def phase12_meteor(dev) -> int:
    """A 2-minute Meteor capture (8.64 M symbols) synthesized on the card
    and decoded sequentially, cold and warm: useful and >= 95 % of the
    planted frames at MM_SYNC_DELAY. Then 32 segments against it. Returns
    the warm run's K3 launch count."""
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
    return launches


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
    _build.build_all(["ddc_fm_u8", "lookahead_walk", "symbol_scan"])
    ddc.build()
    peaks.build()
    pll.build()
    print(f"phase 2: K1, K2 and K3 built and loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    fe = DdcFm(FS, OFFSET_HZ, design.blackmanharris(151), 60_000)
    raw, _ = synth_pass_bytes(80, dev, seed=1)
    k1 = k1_compare(ddc, fe, dev, raw, "phase 3")
    del raw
    noaa_k1 = phase4_decode(ddc, fe, dev)
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
    fc_k3 = phase11_funcube(dev)
    mm_k3 = phase12_meteor(dev)
    phase13_psk_cli(dev)

    print(json.dumps({"kernels": [
        {"name": "ddc_fm_u8", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/ddc_fm_u8.cu",
         "replaces": "directdemod_tpu/ops/pallas_ddc.py:148",
         "launches": noaa_k1 + afsk_k1,
         "launches_by_path": {"noaa": noaa_k1, "afsk1200": afsk_k1},
         **k1, "max_abs_err": max(k1["max_abs_err"], k1_92["max_abs_err"]),
         "ms_j92": k1_92["ms"], "plain_ms_j92": k1_92["plain_ms"]},
        {"name": "lookahead_walk", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/lookahead_walk.cu",
         "replaces": "directdemod_tpu/ops/peaks.py:205",
         "launches": afsk_k2, "launches_by_path": {"afsk1200": afsk_k2},
         **k2, "max_abs_err": max([k2["max_abs_err"]]
                                  + [s["max_abs_err"] for s in stress]),
         "stress_ms": [s["ms"] for s in stress],
         "stress_plain_ms": [s["plain_ms"] for s in stress]},
        {"name": "symbol_scan", "route": "cuda",
         "source": "directdemod_tpu_torch/csrc/symbol_scan.cu",
         "replaces": "directdemod_tpu/ops/pll_scalar.py:67",
         "launches": fc_k3 + mm_k3,
         "launches_by_path": {"funcube": fc_k3, "meteor": mm_k3},
         "max_abs_err": max(v["max_abs_err"] for v in k3.values()),
         "ms": k3["bpsk_1"]["ms"], "plain_ms": k3["bpsk_1"]["plain_ms"],
         **{f"{key}_{f}": v[f] for key, v in k3.items()
            for f in ("ms", "plain_ms", "symbols")}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
