"""Plain reference of the FUNcube-1 BPSK frame-sync decode, from the
capture's bytes.

Written from the upstream DirectDemod decoder (`decode_funcube.py:110-306`)
as its numeric contract stands:

- the front end: the bytes minus 127.5, mixed down by the channel offset
  with the oscillator restarting at every 20,000,000-sample chunk (an
  upstream quirk the decoder keeps), through the 6th-order Butterworth
  low-pass at 7 kHz, whose state before the first sample is that of a
  constant real input of 1. The low-pass is applied as its impulse
  response, cut where it has decayed below 1e-13 of its peak;
- the symbol-rate scan: Gardner timing with the AGC (DC tracker, amplitude
  tracker, gain cap), the Costas loop with lock hysteresis and the
  quantized tanh, and the minsync compare of the last 330 hard decisions
  against the 33-bit sync spread tenfold, written as the plain loop of the
  upstream's per-sample code at the symbol rate;
- the frame syncs: for each planted frame, the correlation of the
  frequency-corrected filtered baseband with the upstream's +127/-128
  needle (1,706 samples a bit), its largest magnitude reported as the
  needle's centre, the upstream's 'same' convention.

It imports nothing of the port and takes nothing the port made, except
where `symbols` follows the port's scan from the port's own state at the
start of a block (said in PERF.md). `precision="fp64"` is the reference;
`"tf32"` is its control: the low-pass in float32 with TF32 convolutions
and the scan's scalar loop rounded to bfloat16 at every operation (TF32
does not apply to a scalar loop; bfloat16 is the float type below float32
there).
"""
from __future__ import annotations

import math
import struct

import numpy as np
import scipy.signal
import torch

from benchmarks.reference.apt import Precision


def lowpass_response(cfg: dict, tol: float = 1e-13) -> np.ndarray:
    """Impulse response of the configuration's Butterworth low-pass, cut
    where every later sample lies below `tol` of the peak."""
    fs = float(cfg["sample_rate"])
    sos = scipy.signal.butter(int(cfg["lowpass_order"]),
                              float(cfg["lowpass_hz"]) / (0.5 * fs), output="sos")
    n = 1 << 12
    while True:
        imp = np.zeros(n)
        imp[0] = 1.0
        h = scipy.signal.sosfilt(sos, imp)
        big = np.flatnonzero(np.abs(h) >= tol * np.abs(h).max())
        if big[-1] < n // 2:
            return h[:big[-1] + 1]
        n *= 2


def filtered(raw: torch.Tensor, cfg: dict, a: int, b: int, h: np.ndarray,
             prec: Precision) -> torch.Tensor:
    """The front end's output at samples [a, b) of the capture."""
    fs = int(cfg["sample_rate"])
    off = int(cfg["offset_hz"])
    blk = int(cfg["block_samples"])
    L = len(h)
    lo = max(a - (L - 1), 0)
    dev = raw.device
    t = torch.arange(lo, b, dtype=torch.int64, device=dev)
    # the oscillator restarts at every chunk: phase of (t - chunk start)
    ph = (2 * np.pi / fs) * torch.remainder(off * (t % blk), fs).to(torch.float64)
    v = raw[2 * lo:2 * b].to(torch.float64) - 127.5
    x = torch.complex(v[0::2], v[1::2]) * torch.polar(torch.ones_like(ph), -ph)
    if a - (L - 1) < 0:
        # the state before the first sample: a constant real input of 1
        x = torch.cat([torch.ones(L - 1 - a, dtype=x.dtype, device=dev), x])
    return prec.conv(x.to(prec.cplx), h[::-1].copy())


def needle(cfg: dict) -> np.ndarray:
    bits = np.asarray([int(c) for c in cfg["sync_bits"]])
    return np.repeat(np.where(bits == 1, 127.0, -128.0),
                     int(cfg["sample_rate"] / cfg["bit_rate"]))


def frame_syncs(raw: torch.Tensor, cfg: dict, starts, prec: Precision,
                margin: int = 30_000) -> list:
    """Each planted frame's sync: the needle's centre at the largest
    correlation magnitude within `margin` samples of the frame."""
    fs = int(cfg["sample_rate"])
    nd = needle(cfg)
    k = len(nd)
    centre = k - 1 - (k - 1) // 2
    h = lowpass_response(cfg)
    n = raw.shape[0] // 2
    out = []
    for s in starts:
        a, b = max(int(s) - margin, 0), min(int(s) + k + margin, n)
        x = filtered(raw, cfg, a, b, h, prec).to(torch.complex128).cpu().numpy()
        # the residual carrier, from the line that squaring the BPSK leaves
        m = 1 << 20
        sq = np.abs(np.fft.fft(x * x, m))
        i = int(np.argmax(sq))
        y0, y1, y2 = sq[i - 1], sq[i], sq[(i + 1) % m]
        frac = 0.5 * (y0 - y2) / (y0 - 2 * y1 + y2)
        f2 = ((i + frac + m // 2) % m - m // 2) * fs / m
        xd = x * np.exp(-1j * np.pi * f2 * np.arange(len(x)) / fs)
        cor = np.abs(scipy.signal.fftconvolve(xd, nd[::-1], mode="valid"))
        out.append(float(a + int(np.argmax(cor)) + centre))
    return out


# ----------------------------------------------------------------- the scan

def _bf16(v: float) -> float:
    """v rounded to the nearest bfloat16 (ties to even)."""
    bits = struct.unpack("<I", struct.pack("<f", v))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _f32(v: float) -> float:
    return float(np.float32(v))


class ScanState:
    """The scan's state, in the port's layout (a float row of 11 and an
    int row of 23, two 8-word shift registers at its end): read from the
    port's state at a block's start, which is the one thing of the port the
    reference takes."""

    FLOATS = ("timing", "gbr", "gbi", "gcr", "gci", "dcr", "dci", "mean",
              "phase", "freq", "pm")

    def __init__(self, f_row, i_row):
        for name, v in zip(self.FLOATS, f_row):
            setattr(self, name, float(v))
        self.stage, self.anchor, self.locked, self.ctr, self.last_min, \
            self.fill, self.chosen = (int(v) for v in i_row[:7])
        self.buf = sum((int(w) & 0xFFFFFFFFFFFFFFFF) << (64 * k)
                       for k, w in enumerate(i_row[7:15]))


def scan(x: np.ndarray, st: ScanState, cfg: dict, precision: str = "fp64"
         ) -> tuple[list, list]:
    """The BPSK scan over the filtered block `x` (complex, indices local to
    it) from `st`: (A-sample index, minsync flag) of every symbol, in
    order."""
    p = cfg["pll"]
    r = _bf16 if precision == "tf32" else (lambda v: v)
    fs, sym = float(cfg["sample_rate"]), float(cfg["symbol_rate"])
    T = _f32(fs / sym)
    halfT, tk = _f32(T / 2.0), _f32(T / 2e6)
    gcap = float(p["agc_gain_cap"])
    bw, zeta = float(p["costas_bw"]), float(p["costas_damping"])

    def gains(bw_):
        den = 1.0 + 2.0 * zeta * bw_ + bw_ * bw_
        return _f32(4 * zeta * bw_ / den), _f32(4 * bw_ * bw_ / den)
    al_u, be_u = gains(bw)
    al_l, be_l = gains(bw / 2.0)
    two_pi = 2.0 * math.pi
    bits = np.asarray([int(c) for c in cfg["sync_bits"]])
    sync = np.repeat(bits, int(sym / cfg["bit_rate"]))
    slen = len(sync)
    s0 = sum(int(b) << (slen - 1 - k) for k, b in enumerate(sync))
    mask = (1 << slen) - 1
    thresh = float(p["minsync_thresh"])
    n = len(x)
    xr, xi = x.real.tolist(), x.imag.tolist()
    cap = int(n / T) + 3 + int(n * 4e-6 / T)

    timing, gbr, gbi, gcr, gci = st.timing, st.gbr, st.gbi, st.gcr, st.gci
    dcr, dci, mean = st.dcr, st.dci, st.mean
    phase, freq, pm = st.phase, st.freq, st.pm
    stage, anchor, locked = st.stage, st.anchor, bool(st.locked)
    ctr, fill, buf = st.ctr, st.fill, st.buf
    a_out, m_out = [], []

    def agc(idx, dcr, dci, mean):
        g_i = max(idx, 0)
        sr, si = (xr[g_i], xi[g_i]) if g_i < n else (0.0, 0.0)
        dcr = r(r(r(dcr * 1048575.0) + sr) * 2.0 ** -20)
        dci = r(r(r(dci * 1048575.0) + si) * 2.0 ** -20)
        vr, vi = r(sr - dcr), r(si - dci)
        mean = r(r(mean * 65535.0 + r(math.hypot(vr, vi))) * 2.0 ** -16)
        g = min(r(180.0 / mean), gcap)
        return r(vr * g), r(vi * g), dcr, dci, mean

    while len(a_out) < cap:
        m_b = math.ceil(r(halfT - timing))
        m_a = math.ceil(r(T - timing))
        idx_b, idx_a = anchor + m_b, anchor + m_a
        at_b = stage == 0
        b_valid = at_b and idx_b < n
        if b_valid:
            gbr, gbi, dcr, dci, mean = agc(idx_b, dcr, dci, mean)
        if idx_a >= n:
            break
        gar, gai, dcr, dci, mean = agc(idx_a, dcr, dci, mean)
        resync = r(r(gai - gci) * gbi)
        timing = r(r(r(timing + m_a) - T) + r(resync * tk))
        a_out.append(idx_a)
        stage, anchor = 0, idx_a
        gcr, gci = gar, gai
        # the Costas loop
        cr, sr = r(math.cos(phase)), -r(math.sin(phase))
        re = r(r(gar * cr) - r(gai * sr))
        im = r(r(gar * sr) + r(gai * cr))
        if re > 127.0:
            hyp = 1.0
        elif re < -128.0:
            hyp = -1.0
        else:
            hyp = math.tanh(min(max(math.floor(re + 128.0), 0), 255) - 128)
        err = r(r(im * hyp) / 255.0)
        pm = r(r(pm * 39999.0 + abs(err)) / 40000.0)
        ec = min(max(err, -1.0), 1.0)
        al, be = (al_l, be_l) if locked else (al_u, be_u)
        raw = r(r(phase + freq) + r(al * ec))
        phase = math.copysign(math.fmod(abs(raw), two_pi), raw) if raw else 0.0
        freq = r(freq + r(be * ec))
        if not locked and pm < 0.2:
            locked = True
        elif locked and pm > 0.5:
            locked = False
        # minsync
        ctr += 1
        buf = ((buf << 1) | int(re > 0.0)) & mask
        fill = min(fill + 1, slen)
        m_out.append(fill >= slen and abs((buf ^ s0).bit_count() - slen / 2.0) > thresh)
    return a_out, m_out
