"""Plain reference of the Meteor-M2 LRPT frame-sync decode, from the
capture's bytes.

Written from the upstream DirectDemod decoder (`decode_meteorm2.py:110-332`)
as its numeric contract stands in `directdemod_tpu/models/meteorm2.py` and
`directdemod_tpu/ops/pll.py`:

- the front end: `benchmarks.reference.bpsk.filtered` with the meteor
  configuration's keys (the oscillator restarting at every 20,000,000-sample
  chunk, the 6th-order Butterworth low-pass at 70 kHz with the state of a
  constant real input of 1 before the first sample);
- the symbol-rate scan (`scan`): Gardner timing with the AGC (DC tracker,
  amplitude tracker, gain cap 200), the Costas loop with the four-quadrant
  error im hyp(re) - re hyp(im) over the quantized tanh and lock
  hysteresis, and the minsync compare: while the gate is open (no minsync
  yet, or more than 0.1 symbol_rate symbols since the last), each symbol's
  sign bits are pushed into two 120-entry registers, (re, im) and
  (im, re), compared with the sync and with its odd-flipped variant; a
  compare beyond the threshold fires, and the needle choice is 0 for the
  first, 2 for the second, the last assignment winning (the upstream's
  quirk, `directdemod_tpu/ops/pll.py:239`), as a plain loop at the symbol
  rate. The step budget `int(n/T) + 3 + int(n 4e-6/T)` is the JAX scan's
  contract, which the port keeps, so the reference keeps it too;
- the frame syncs (`frame_syncs`): for each planted frame, the filtered
  baseband derotated by the carrier, quantized as the upstream quantizes
  it (lim(re/2), lim(im/2), interleaved), correlated with the upstream's
  three needles (each sync entry repeated 28 times, +127/-128, over the
  interleaved entries), the largest magnitude within `margin` samples of
  the frame reported in the decoder's convention: the needle's 'same'
  centre over the entries, halved into samples.

Departures from the upstream, each forced by a reference that needs no PLL
of its own for the syncs: the carrier's frequency is estimated once per
capture from the fourth-power spectral line of the filtered first block,
and its phase once per frame from the frame's own fourth power; the four
quarter-turn rotations that leaves open are all tried, with the three
needles, where the upstream correlates at its PLL's phase with the needle
its minsync chose. `scan` follows the port's scan from the port's own state
at the start of a block (said in PERF.md).

It imports nothing of the port. `precision="fp64"` is the reference;
`"tf32"` is its control: the low-pass in float32 with TF32 convolutions
and the scan's scalar loop rounded to bfloat16 at every operation.
"""
from __future__ import annotations

import math

import numpy as np
import scipy.signal
import torch

from benchmarks.reference.apt import Precision
from benchmarks.reference.bpsk import ScanState as _BpskState
from benchmarks.reference.bpsk import _bf16, _f32, filtered, lowpass_response

__all__ = ["ScanState", "scan", "frame_syncs", "filtered", "lowpass_response",
           "variants", "needles"]


class ScanState(_BpskState):
    """The scan's state in the port's layout, with the second register
    (the (im, re) one) from the int row's last eight words."""

    def __init__(self, f_row, i_row):
        super().__init__(f_row, i_row)
        self.buf2 = sum((int(w) & 0xFFFFFFFFFFFFFFFF) << (64 * k)
                        for k, w in enumerate(i_row[15:23]))


def initial_rows(cfg: dict) -> tuple[list, list]:
    """The decoder's state before a capture's first sample, as the float
    and int rows of the port's layout: the AGC's mean, the loop's frequency
    and its phase mean set, no minsync yet."""
    f = [0.0] * 11
    f[7], f[9], f[10] = cfg["pll"]["agc_mean0"], 0.001, 1.0
    i = [0] * 23
    i[4] = -1
    return f, i


def initial_state(cfg: dict) -> ScanState:
    return ScanState(*initial_rows(cfg))


def variants(cfg: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The sync and its two phase-ambiguity variants: odd entries flipped,
    even entries flipped."""
    s = np.asarray(cfg["sync_entries"], np.int64)
    k = np.arange(len(s))
    return s, np.where(k % 2 == 0, s, 1 - s), np.where(k % 2 == 1, s, 1 - s)


def needles(cfg: dict) -> list:
    """The upstream's three needles: each entry of a variant as +127 or
    -128, repeated int(sample_rate / symbol_rate) times."""
    rep = int(cfg["sample_rate"] / cfg["symbol_rate"])
    return [np.repeat(np.where(v == 1, 127.0, -128.0), rep) for v in variants(cfg)]


def scan(x: np.ndarray, st: ScanState, cfg: dict, precision: str = "fp64"
         ) -> tuple[list, list, list]:
    """The QPSK scan over the filtered block `x` (complex, indices local to
    it) from `st`: the A-sample index, minsync flag and needle choice of
    every symbol, in order."""
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
    s, alt1, _ = variants(cfg)
    slen = len(s)
    s0 = sum(int(b) << (slen - 1 - k) for k, b in enumerate(s))
    s1 = sum(int(b) << (slen - 1 - k) for k, b in enumerate(alt1))
    mask = (1 << slen) - 1
    thresh = float(p["minsync_thresh"])
    gate_syms = int(0.1 * sym)
    n = len(x)
    xr, xi = x.real.tolist(), x.imag.tolist()
    cap = int(n / T) + 3 + int(n * 4e-6 / T)

    timing, gbr, gbi, gcr, gci = st.timing, st.gbr, st.gbi, st.gcr, st.gci
    dcr, dci, mean = st.dcr, st.dci, st.mean
    phase, freq, pm = st.phase, st.freq, st.pm
    stage, anchor, locked = st.stage, st.anchor, bool(st.locked)
    ctr, last_min, fill, chosen = st.ctr, st.last_min, st.fill, st.chosen
    buf, buf2 = st.buf, st.buf2
    a_out, m_out, c_out = [], [], []

    def agc(idx, dcr, dci, mean):
        g_i = max(idx, 0)
        sr, si = (xr[g_i], xi[g_i]) if g_i < n else (0.0, 0.0)
        dcr = r(r(r(dcr * 1048575.0) + sr) * 2.0 ** -20)
        dci = r(r(r(dci * 1048575.0) + si) * 2.0 ** -20)
        vr, vi = r(sr - dcr), r(si - dci)
        mean = r(r(mean * 65535.0 + r(math.hypot(vr, vi))) * 2.0 ** -16)
        g = min(r(180.0 / mean), gcap)
        return r(vr * g), r(vi * g), dcr, dci, mean

    def hyp(v):
        if v > 127.0:
            return 1.0
        if v < -128.0:
            return -1.0
        return math.tanh(min(max(math.floor(v + 128.0), 0), 255) - 128)

    while len(a_out) < cap:
        m_b = math.ceil(r(halfT - timing))
        m_a = math.ceil(r(T - timing))
        idx_b, idx_a = anchor + m_b, anchor + m_a
        at_b = stage == 0
        if at_b and idx_b < n:
            gbr, gbi, dcr, dci, mean = agc(idx_b, dcr, dci, mean)
        if idx_a >= n:
            break
        gar, gai, dcr, dci, mean = agc(idx_a, dcr, dci, mean)
        resync = r(r(gai - gci) * gbi)
        timing = r(r(r(timing + m_a) - T) + r(resync * tk))
        a_out.append(idx_a)
        stage, anchor = 0, idx_a
        gcr, gci = gar, gai
        # the Costas loop, four-quadrant error
        cr, sr = r(math.cos(phase)), -r(math.sin(phase))
        re = r(r(gar * cr) - r(gai * sr))
        im = r(r(gar * sr) + r(gai * cr))
        err = r(r(r(im * hyp(re)) - r(re * hyp(im))) / 255.0)
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
        # minsync: two registers, gated after a minsync
        ctr += 1
        bre, bim = int(re > 0.0), int(im > 0.0)
        fired = False
        if last_min < 0 or ctr > last_min + gate_syms:
            buf = ((buf << 2) | (bre << 1) | bim) & mask
            buf2 = ((buf2 << 2) | (bim << 1) | bre) & mask
            fill = min(fill + 2, slen)
            if fill >= slen:
                if abs((buf ^ s0).bit_count() - slen / 2.0) > thresh:
                    chosen, fired = 0, True
                if abs((buf2 ^ s1).bit_count() - slen / 2.0) > thresh:
                    chosen, fired = 2, True
        if fired:
            last_min = ctr
        m_out.append(fired)
        c_out.append(chosen)
    return a_out, m_out, c_out


# ------------------------------------------------------------ the frame syncs

def _lim(v: np.ndarray) -> np.ndarray:
    """The upstream's quantizer: truncate toward zero, (0, 1) -> 1,
    (-1, 0) -> -1, clamp to [-128, 127]."""
    out = np.trunc(v)
    out = np.where((v > 0) & (v < 1), 1.0, out)
    out = np.where((v > -1) & (v < 0), -1.0, out)
    return np.clip(out, -128, 127)


def carrier_hz(raw: torch.Tensor, cfg: dict, prec: Precision,
               n_fft: int = 1 << 22) -> float:
    """The residual carrier of the filtered capture, from the line that the
    fourth power of QPSK leaves: over the first `n_fft` samples (inside
    the first oscillator chunk), interpolated between FFT bins."""
    fs = int(cfg["sample_rate"])
    n = min(n_fft, raw.shape[0] // 2, int(cfg["block_samples"]))
    h = lowpass_response(cfg)
    x = filtered(raw, cfg, 0, n, h, prec).to(torch.complex128)
    x4 = x * x
    x4 = x4 * x4
    sp = torch.fft.fft(x4 * torch.hann_window(n, dtype=torch.float64,
                                              device=x.device)).abs().cpu().numpy()
    i = int(np.argmax(sp))
    y0, y1, y2 = np.log(sp[i - 1]), np.log(sp[i]), np.log(sp[(i + 1) % n])
    frac = 0.5 * (y0 - y2) / (y0 - 2 * y1 + y2)
    f4 = ((i + frac + n // 2) % n - n // 2) * fs / n
    return f4 / 4.0


def frame_syncs(raw: torch.Tensor, cfg: dict, starts, prec: Precision,
                margin: int = 400) -> list:
    """Each planted frame's sync in the decoder's convention: the start of
    the window plus half the entry index of the largest correlation
    magnitude ('same' centre), over the three needles and four quarter
    turns, the needle lying within `margin` samples of the frame."""
    fs = int(cfg["sample_rate"])
    nds = needles(cfg)
    k = len(nds[0])
    half = k - 1 - (k - 1) // 2          # 'same': centre entry past the start
    span = k // 2 + 1                     # samples the needle covers
    h = lowpass_response(cfg)
    f_c = carrier_hz(raw, cfg, prec)
    blk = int(cfg["block_samples"])
    n = raw.shape[0] // 2
    w = np.stack([nd[::-1] for nd in nds])
    out = []
    for s in starts:
        a = max(int(s) - margin, 0)
        b = min(int(s) + span + 2 * margin, n)
        x = filtered(raw, cfg, a, b, h, prec).to(torch.complex128).cpu().numpy()
        # the carrier: its frequency once per capture, its phase from the
        # frame's own fourth power; the oscillator restarts every chunk, so
        # time runs from the chunk's start
        t = (a + np.arange(len(x))) % blk
        xd = x * np.exp(-2j * np.pi * f_c * t / fs)
        # the constellation on the diagonals: its fourth power at pi
        xd *= np.exp(-1j * (np.angle(np.sum(xd ** 4)) - np.pi) / 4.0)
        best = (-1.0, 0)
        for q in range(4):
            rot = xd * (1j ** q)
            vals = np.empty(2 * len(rot))
            vals[0::2] = _lim(rot.real / 2.0)
            vals[1::2] = _lim(rot.imag / 2.0)
            for wi in w:
                cor = np.abs(scipy.signal.fftconvolve(vals, wi, mode="valid"))
                j = int(np.argmax(cor))
                if cor[j] > best[0]:
                    best = (float(cor[j]), j)
        out.append(a + (best[1] + half) / 2.0)
    return out
