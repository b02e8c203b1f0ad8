"""Plain reference of the AFSK1200 / APRS decode, from the capture's bytes.

Written from the upstream DirectDemod decoder (`decode_afsk1200.py:15-405`,
`peakdetect.py:141-254`, `framechecksequence.py`) as its numeric contract
stands, over any stretch of the FM audio:

- the FM front end of `reference/apt.py::fm_audio`: the bytes minus 127.5
  mixed down by the offset, the 151-tap Blackman-Harris low-pass at every
  92nd sample (bw 22,050), the polar discriminator, the first output
  dropped;
- the 6th-order Butterworth band-pass 700-2,700 Hz (designed by
  `scipy.signal.butter` at the decimated rate), applied as its impulse
  response cut where it has decayed below 1e-13 of its peak, its state
  before the first sample that of a constant input of 1;
- the mark/space bank: four correlators over round(bw / baud) = 18 taps,
  timed at the nominal bw, each output the sliding dot product with the
  samples that follow it; the last 18 outputs of a capture zero;
- the edge correlation of sign(bf) with 9 times -1 then 9 times +1,
  `scipy.signal.correlate(..., 'same')`, over 18, its magnitude;
- `peakdetect` with lookahead 11 and delta 0, one step a sample in plain
  Python, its first event popped;
- each gap between positive peaks of r = round(gap / 18.375) bauds cut into
  r windows of 18 samples from the earlier peak, the sign of each window's
  mean of bf an NRZI level; NRZI decode (1 where the level holds), flag
  search (01111110), unstuffing (a bit after five 1s dropped), the
  length tests, CRC-16-CCITT (X.25) and the AX.25 address parse.

Departures from DirectDemod: `get_msg` there returns a placeholder
(`decode_afsk1200.py:283`), here every frame's payload; a stretch
`[m0, m1)` of the audio is computed from the bytes around it alone (the
band-pass sees the 1e-13 tail of its response, so the samples before it
matter no further), and its walk starts from peakdetect's initial state
at `m0`.

It imports nothing of the port and takes nothing the port made: only the
bytes and the configuration. `precision="fp64"` is the reference, with
TF32 off; `"tf32"` is its control, the same chain in float32 with the
convolutions in TF32 (`reference/apt.Precision`).
"""
from __future__ import annotations

import contextlib

import numpy as np
import scipy.signal
import torch

from benchmarks.reference.apt import Precision, fm_audio

FLAG = (0, 1, 1, 1, 1, 1, 1, 0)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in cuBLAS and cuDNN on for the control, off otherwise."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def rates(cfg: dict) -> tuple[int, int]:
    """(decimation stride, the audio's integer rate)."""
    fs = int(cfg["sample_rate"])
    j = fs // int(cfg["bw"])
    return j, int(fs / j)


def audio_length(raw: torch.Tensor, cfg: dict) -> int:
    """Samples of the whole capture's FM audio."""
    return -(-(raw.shape[0] // 2) // rates(cfg)[0]) - 1


def bandpass_response(cfg: dict, tol: float = 1e-13) -> np.ndarray:
    """Impulse response of the band-pass, cut where every later sample lies
    below `tol` of the peak."""
    lo, hi = cfg["bandpass_hz"]
    rate = rates(cfg)[1]
    sos = scipy.signal.butter(int(cfg["bandpass_order"]),
                              [lo / (0.5 * rate), hi / (0.5 * rate)],
                              btype="bandpass", output="sos")
    n = 1 << 12
    while True:
        imp = np.zeros(n)
        imp[0] = 1.0
        h = scipy.signal.sosfilt(sos, imp)
        big = np.flatnonzero(np.abs(h) >= tol * np.abs(h).max())
        if big[-1] < n // 2:
            return h[:big[-1] + 1]
        n *= 2


def audio(raw: torch.Tensor, cfg: dict, a: int, b: int, prec: Precision
          ) -> torch.Tensor:
    """FM audio samples [a, b) of the capture. Past sample 1 of the audio
    the bytes are cut two outputs earlier, on the decimation grid; those
    two outputs, which read the front end's virtual past, are dropped. A
    cut changes the mixer's phase by a constant, which the discriminator
    does not see."""
    j = rates(cfg)[0]
    fs, off = int(cfg["sample_rate"]), float(cfg["offset_hz"])
    k0 = a - 2 if a >= 2 else 0
    x = fm_audio(raw[2 * j * k0: 2 * (j * b + 1)], fs, off, int(cfg["bw"]),
                 int(cfg["frontend_taps"]), prec)
    return x[a - k0: b - k0]


def bank(sig: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """The mark/space energy difference at every sample with 18 samples
    from it on in `sig` (len(sig) - 17 outputs)."""
    bw, baud = int(cfg["bw"]), int(cfg["baud"])
    buf = int(round(bw / baud))
    i = np.arange(buf) / bw
    out = []
    for hz in (cfg["mark_hz"], cfg["space_hz"]):
        for f in (np.cos, np.sin):
            out.append(prec.conv(sig, f(2 * np.pi * hz * i)))
    mi, mq, si, sq = out
    return mi * mi + mq * mq - si * si - sq * sq


def edges(raw: torch.Tensor, cfg: dict, m0: int, m1: int, precision: str = "fp64"
          ) -> dict:
    """bf at audio indices [m0, m1 + 64) and the edge strength at [m0, m1)
    (both cut at the capture's end), as float64 host arrays: {"bf",
    "edge", "m0"}."""
    prec = Precision(precision)
    with tf32(precision == "tf32"):
        M = audio_length(raw, cfg)
        h = bandpass_response(cfg)
        L = len(h)
        spb = int(cfg["bw"]) // int(cfg["baud"])
        buf = int(round(int(cfg["bw"]) / int(cfg["baud"])))
        m1 = min(m1, M)
        lo = max(m0 - spb - (L - 1), 0)
        hi = min(m1 + 64 + buf + spb, M)
        x = audio(raw, cfg, lo, hi, prec).to(prec.real)
        if lo == 0:
            x = torch.cat([torch.ones(L - 1, dtype=x.dtype, device=x.device), x])
            s0 = 0
        else:
            s0 = lo + L - 1
        sig = prec.conv(x, h[::-1].copy())              # samples [s0, hi)
        bf = bank(sig, cfg, prec)                         # [s0, hi - buf + 1)
        # [s0, hi - buf), or to the capture's end with its last buf zero
        bf = bf[: hi - buf - s0] if hi < M else torch.cat(
            [bf[: M - buf - s0], bf.new_zeros(buf)])
        bf = bf.to(torch.float64).cpu().numpy()
    taps = np.concatenate([-np.ones(spb // 2), np.ones(spb - spb // 2)])
    edge = np.abs(scipy.signal.correlate(np.sign(bf), taps, mode="same")) / spb
    return {"bf": bf[m0 - s0: m1 + 64 - s0], "edge": edge[m0 - s0: m1 - s0], "m0": m0}


def peakdetect(y: np.ndarray, lookahead: int, delta: float = 0.0) -> list:
    """The upstream walk over y: every event (index, position, value,
    is_max) in order, before the pop of the first."""
    events = []
    mx, mn = -np.inf, np.inf
    mxpos = mnpos = 0
    length = len(y)
    ys = y.tolist()
    for index in range(length - lookahead):
        v = ys[index]
        if v > mx:
            mx, mxpos = v, index
        if v < mn:
            mn, mnpos = v, index
        if v < mx - delta and mx != np.inf:
            if y[index:index + lookahead].max() < mx:
                events.append((index, mxpos, mx, True))
                mx = mn = np.inf
                if index + lookahead >= length:
                    break
                continue
        if v > mn + delta and mn != -np.inf:
            if y[index:index + lookahead].min() > mn:
                events.append((index, mnpos, mn, False))
                mn = mx = -np.inf
                if index + lookahead >= length:
                    break
    return events


def max_peaks(events: list) -> np.ndarray:
    """The positive peaks' positions, the first event popped."""
    return np.asarray([p for _, p, _, is_max in events[1:] if is_max], np.int64)


def nrzi_levels(bf: np.ndarray, pk: np.ndarray, cfg: dict) -> list:
    """The sign of bf's mean over each baud window between the peaks `pk`
    (indices into `bf`); an empty window reads 0."""
    bw, baud = int(cfg["bw"]), int(cfg["baud"])
    spb, spb_f = bw // baud, bw / baud
    out = []
    for p, q in zip(pk[:-1], pk[1:]):
        for k in range(max(int(np.round((q - p) / spb_f)), 0)):
            w = bf[p + k * spb: p + (k + 1) * spb]
            out.append(float(np.sign(w.mean())) if len(w) else 0.0)
    return out


def fcs(bits: list) -> int:
    """CRC-16-CCITT (X.25) of a bit sequence sent least significant bit
    first: reflected polynomial 0x8408, preset 0xFFFF, complemented."""
    reg = 0xFFFF
    for bit in bits:
        reg = (reg >> 1) ^ 0x8408 if (reg ^ bit) & 1 else reg >> 1
    return reg ^ 0xFFFF


def parse(msg: list) -> tuple:
    """The AX.25 parse of a frame's bits without its FCS: the address
    bytes' top seven bits as characters up to the byte whose extension
    bit is set, then control, PID and info. Returns (destination, source,
    path, control, PID, info)."""
    data = [sum(b << i for i, b in enumerate(msg[k:k + 8]))
            for k in range(0, len(msg) - 7, 8)]
    n = next((k + 1 for k, v in enumerate(data) if v & 1), len(data))
    head = "".join(chr(v >> 1) for v in data[:n])
    pay = data[n:]
    return (head[:7], head[7:14], head[14:], pay[0] if pay else None,
            pay[1] if len(pay) > 1 else None, "".join(chr(v) for v in pay[2:]))


def frames(levels: list) -> tuple[list, dict]:
    """The bit layer over NRZI levels: the CRC-valid frames' fields in
    order, and the counts {"bauds", "flags", "crc_checks", "frames"}."""
    bits = [1] + [int(a == b) for a, b in zip(levels[1:], levels[:-1])] \
        if levels else []
    marks, run = [], 0
    for b in bits:
        marks.append((2 if b else 1) if run == 5 else 0)
        run = run + 1 if b else 0
    flags = [i for i in range(len(bits) - 7) if tuple(bits[i:i + 8]) == FLAG]
    out, checked = [], 0
    for f, g in zip(flags[:-1], flags[1:]):
        seg = [b for b, m in zip(bits[f + 8:g], marks[f + 8:g]) if m == 0]
        msg = seg[:-16]
        if len(seg) % 8 == 0 and len(msg) > 16 * 8:
            checked += 1
            if fcs(msg) == sum(b << i for i, b in enumerate(seg[-16:])):
                out.append(parse(msg))
    return out, {"bauds": len(levels), "flags": len(flags), "crc_checks": checked,
                 "frames": len(out)}


def decode(raw: torch.Tensor, cfg: dict, m0: int = 0, m1: int | None = None,
           precision: str = "fp64") -> dict:
    """The reference over audio [m0, m1) (the whole capture by default):
    {"bf", "edge", "m0", "events" (global indices), "peaks", "frames",
    "counts"}."""
    M = audio_length(raw, cfg)
    m1 = M if m1 is None else min(m1, M)
    r = edges(raw, cfg, m0, m1, precision)
    ev = peakdetect(r["edge"], int(cfg["lookahead"]))
    pk = max_peaks(ev)
    fr, counts = frames(nrzi_levels(r["bf"], pk, cfg))
    return {**r, "events": [(i + m0, p + m0, v, k) for i, p, v, k in ev],
            "peaks": pk + m0, "frames": fr, "counts": counts}
