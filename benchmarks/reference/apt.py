"""Plain reference of the NOAA APT decode, from the capture's bytes.

Written from the upstream DirectDemod decoder (`decode_noaa.py`, `comm.py`,
`demod_fm.py`, `demod_am.py`) as its numeric contract stands: the FM front
end (NCO, a 151-tap Blackman-Harris FIR, decimation by an integer stride,
the polar discriminator), the crude sync (blocked Hilbert envelope of
240,000 samples, normalized correlation with the 40-word sync needles,
top-k threshold, min-distance grouping), the usefulness test, the image
(zero-phase Butterworth band-pass, blocked envelope, per-line Fourier
resample and pixel medians, the calibration-wedge walk, uint8
quantization) and the accurate sync (per-window NCO, zero-phase FIRs, FM,
envelope and normalized correlation at the full rate).

It imports nothing of the port and takes nothing the port made: only the
bytes and the configuration. `precision="fp64"` is the reference;
`precision="tf32"` is its control, the same chain in float32 with the
convolutions in TF32 (the step that would tempt a later change: the port
turns TF32 off at import).
"""
from __future__ import annotations

import numpy as np
import scipy.signal
import torch
import torch.nn.functional as F

AM_BLOCK = 240_000
WINDOW_GROUP = 64
SYNCA = (0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0,
         1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
SYNCB = (0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1,
         1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0)
T_WORD = 1.0 / 4160
WIGGLE = 0.25
MIN_PEAK_DIST_S = 0.45
DETECT_MAX_CHANGE = 5
DETECT_CONS_SYNCS = 10
FIFO_LEN = 10_000


def _cos_window(n: int, coeffs) -> np.ndarray:
    k = np.arange(n) * (2 * np.pi / (n - 1))
    return sum(((-1) ** i) * c * np.cos(i * k) for i, c in enumerate(coeffs))


def blackmanharris(n: int) -> np.ndarray:
    return _cos_window(n, (0.35875, 0.48829, 0.14128, 0.01168))


def hamming(n: int) -> np.ndarray:
    return _cos_window(n, (0.54, 0.46))


def needle(bits, rate: float) -> np.ndarray:
    """The positive APT needle: each word `round(rate * T)` samples,
    {0, 1} -> {11, 244} / 255."""
    rep = int(round(rate * T_WORD))
    return (np.repeat(np.asarray(bits, np.float64), rep) * 233.0 + 11.0) / 255.0


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's values rounded to TF32 (10 mantissa bits, ties
    to even), as the tensor cores round a TF32 product's operands."""
    if t.is_complex():
        return torch.view_as_complex(round_tf32(torch.view_as_real(t)))
    b = t.to(torch.float32).contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Precision:
    """The arithmetic of a reference run: fp64 with exact FFT
    convolutions, or its control, float32 with TF32 convolutions: every
    convolution's operands rounded to TF32, the products summed in float32
    (what cuDNN does with TF32 on; its single-channel convolutions here
    pick kernels that ignore the switch, so the rounding is explicit)."""

    def __init__(self, name: str):
        if name not in ("fp64", "tf32"):
            raise ValueError(f"precision {name!r}: fp64 or tf32")
        self.name = name
        self.real = torch.float64 if name == "fp64" else torch.float32
        self.cplx = torch.complex128 if name == "fp64" else torch.complex64

    def conv(self, x: torch.Tensor, w: np.ndarray, stride: int = 1) -> torch.Tensor:
        """VALID sum_i w[i] x[..., stride m + i] over the last axis for real
        taps; complex x is its two real parts."""
        if x.is_complex():
            y = self.conv(torch.view_as_real(x).movedim(-1, -2), w, stride)
            return torch.complex(y[..., 0, :], y[..., 1, :])
        lead = x.shape[:-1]
        xr = x.reshape(-1, 1, x.shape[-1]).to(self.real)
        wt = torch.as_tensor(np.ascontiguousarray(w), dtype=self.real, device=x.device)
        if self.name == "tf32":
            y = F.conv1d(round_tf32(xr), round_tf32(wt).reshape(1, 1, -1),
                         stride=stride)
        else:
            n_out = (x.shape[-1] - len(w)) // stride + 1
            y = _fft_valid(xr[:, 0], wt)[:, ::stride][:, :n_out].reshape(-1, 1, n_out)
        return y.reshape(lead + (y.shape[-1],))


def _fft_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID correlation of each row of x with w, by FFT."""
    n, k = x.shape[-1], w.shape[-1]
    m = 1 << (n + k - 1).bit_length()
    full = torch.fft.irfft(torch.fft.rfft(x, m) * torch.fft.rfft(w.flip(-1), m), m)
    return full[..., k - 1:n]


def fft_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """np.convolve(x, w, 'same') along the last axis, by FFT."""
    n, k = x.shape[-1], w.shape[-1]
    m = 1 << (n + k - 1).bit_length()
    full = torch.fft.irfft(torch.fft.rfft(x, m) * torch.fft.rfft(w, m), m)
    s = (k - 1) // 2
    return full[..., s:s + n]


def norm_correlate(h: torch.Tensor, nd: torch.Tensor) -> torch.Tensor:
    """correlate(h, needle, 'same') / sqrt(moving energy * needle energy)."""
    cor = fft_same(h, nd.flip(-1))
    energy = fft_same(h * h, torch.ones_like(nd))
    return cor / torch.sqrt(energy * torch.sum(nd * nd))


def envelope(x: torch.Tensor) -> torch.Tensor:
    """|hilbert(x)| along the last axis."""
    n = x.shape[-1]
    h = torch.zeros(n, dtype=x.dtype, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(torch.fft.fft(x, dim=-1) * h, dim=-1).abs()


def envelope_blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    n = x.shape[0]
    nfull = n // block
    parts = []
    if nfull:
        parts.append(envelope(x[:nfull * block].reshape(nfull, block)).reshape(-1))
    if n > nfull * block:
        parts.append(envelope(x[nfull * block:]))
    return torch.cat(parts)


def fir_zero_phase(x: torch.Tensor, taps: np.ndarray, prec: Precision) -> torch.Tensor:
    """filtfilt(b, [1], x) along the last axis: odd extension of 3 k
    samples at each end, each pass seeded with its first sample as a
    constant past."""
    k = len(taps)
    pad = 3 * k
    n = x.shape[-1]
    head = 2 * x[..., :1] - x[..., 1:pad + 1].flip(-1)
    tail = 2 * x[..., -1:] - x[..., -pad - 1:-1].flip(-1)
    ext = torch.cat([head, x, tail], dim=-1)

    def causal(v):
        past = v[..., :1].expand(v.shape[:-1] + (k - 1,))
        return prec.conv(torch.cat([past, v], dim=-1), taps[::-1].copy())

    yb = causal(causal(ext).flip(-1)).flip(-1)
    return yb[..., pad:pad + n]


def adaptive_threshold(cor: torch.Tensor, rate: float) -> torch.Tensor:
    n = cor.shape[-1]
    k = int(2 * (n / rate)) + 2
    top = torch.topk(cor, k, dim=-1).values.mean(dim=-1)
    bot = (-torch.topk(-cor, k, dim=-1).values).mean(dim=-1)
    return top - WIGGLE * (top - bot)


def group_peaks(indices, values, min_dist: float) -> np.ndarray:
    """Keep the largest candidate of each run whose members lie closer
    than `min_dist` to the run's current best."""
    best_i, best_v, out = None, None, []
    for i, v in zip(indices, values):
        if best_i is not None and (i - best_i) >= min_dist:
            out.append(best_i)
            best_i, best_v = None, None
        if best_v is None or best_v < v:
            best_i, best_v = i, v
    out.append(best_i)
    return np.sort(np.asarray([o for o in out if o is not None], np.int64))


# ----------------------------------------------------------------- front end

def fm_audio(raw: torch.Tensor, fs: int, offset: float, bw: int, ntaps: int,
             prec: Precision, chunk_out: int = 1 << 21) -> torch.Tensor:
    """FM audio at fs // (fs // bw), as the decoder's crude-sync chain
    keeps it (the first discriminator output dropped): the bytes minus
    127.5 mixed down by `offset` (an exact phase), an all-ones mixed past
    before the first sample, the Blackman-Harris FIR at every `J`-th
    sample, then angle(c[m] conj(c[m - 1]))."""
    J = int(fs // bw)
    taps = blackmanharris(ntaps)
    n = raw.shape[0] // 2
    M = -(-n // J)
    dev = raw.device
    off_i = int(round(offset))
    if off_i != offset:
        raise ValueError("the reference mixes by a whole number of Hz")
    outs = []
    c_last = None
    for m0 in range(0, M, chunk_out):
        m1 = min(M, m0 + chunk_out)
        a, b = J * m0 - (ntaps - 1), J * (m1 - 1) + 1
        lo = max(a, 0)
        t = torch.arange(lo, b, dtype=torch.int64, device=dev)
        ph = (2 * np.pi / fs) * torch.remainder(off_i * t, fs).to(torch.float64)
        v = raw[2 * lo:2 * b].to(torch.float64) - 127.5
        x = torch.complex(v[0::2], v[1::2]) * torch.polar(torch.ones_like(ph), -ph)
        if a < 0:
            x = torch.cat([torch.ones(-a, dtype=x.dtype, device=dev), x])
        c = prec.conv(x.to(prec.cplx), taps[::-1].copy(), J)[: m1 - m0]
        prev = torch.cat([c[:1] * 0 if c_last is None else c_last, c[:-1]])
        d = torch.angle(c * prev.conj())
        outs.append(d if c_last is not None else d[1:])
        c_last = c[-1:]
        del x, v, ph, t
    return torch.cat(outs)


# ----------------------------------------------------------------- crude sync

def crude_sync(audio: torch.Tensor, rate: int) -> tuple[list, list]:
    """Crude syncs of needles A and B, and each needle's normalized
    correlation, indexed by sync + the needle's half length."""
    env = envelope_blocked(audio, AM_BLOCK)
    syncs, cors = [], []
    for bits in (SYNCA, SYNCB):
        nd = torch.as_tensor(needle(bits, rate), dtype=env.dtype, device=env.device)
        cor = norm_correlate(env, nd)
        cors.append(cor)
        thr = adaptive_threshold(cor, rate)
        idx = torch.nonzero(cor > thr).reshape(-1)
        if idx.numel() == 0:
            syncs.append(np.empty(0, np.int64))
            continue
        g = group_peaks(idx.cpu().tolist(), cor[idx].cpu().tolist(),
                        MIN_PEAK_DIST_S * rate)
        syncs.append(np.sort(g - nd.shape[0] // 2))
    return syncs, cors


def useful(sync_a, sync_b, rate) -> int:
    for syncs in (sync_a, sync_b):
        d = np.abs(np.diff(syncs) - rate * 0.5)
        w = DETECT_CONS_SYNCS
        if len(d) >= w:
            wins = np.lib.stride_tricks.sliding_window_view(d, w)
            if np.min(np.max(wins, axis=-1)) < DETECT_MAX_CHANGE:
                return 1
    return 0


# ----------------------------------------------------------------- image

def fill_syncs(csync, max_len) -> list:
    """Keep syncs spaced within 200 samples of the modal spacing, then fill
    the missed ones backward from the first and forward from each."""
    wiggle = 200
    csync = list(csync)
    if len(csync) < 2:
        return sorted(float(c) for c in csync)
    vals, counts = np.unique(np.diff(csync), return_counts=True)
    mode = vals[np.argmax(counts)]
    if mode <= wiggle:
        return sorted(float(c) for c in csync)
    valid = []
    for i in range(len(csync) - 1):
        if abs(csync[i + 1] - csync[i] - mode) < wiggle:
            for c in (csync[i], csync[i + 1]):
                if c not in valid:
                    valid.append(c)
    corrected = valid[:]
    c = valid[0] - mode
    while c > wiggle:
        corrected.append(c)
        c -= mode
    anchor, c = 0, mode
    while valid[anchor] + c < max_len:
        nxt = anchor + 1 < len(valid)
        if nxt and (abs(valid[anchor + 1] - c - valid[anchor]) < wiggle
                    or c + valid[anchor] > valid[anchor + 1]):
            anchor += 1
            c = mode
        else:
            corrected.append(valid[anchor] + c)
            c += mode
    return list(np.sort(corrected))


class _Calib:
    """The calibration-wedge walk (upstream decode_noaa.py:315-425)."""

    def __init__(self, low, high):
        self.low, self.high = low, high
        self.low_fifo, self.high_fifo = np.empty(0), np.empty(0)
        self.corr_pix, self.corr_sig, self.corr_sig2 = [], [], []
        self.chid1, self.chid2 = [], []
        self.last_pix = self.last_sig = None
        self.state = 0
        self.wedge_pix, self.wedge_sig = [], []
        self.slope = self.intercept = None
        self.locks = 0

    def from_sync_train(self, head):
        bits = np.asarray(SYNCA)
        self.low_fifo = np.concatenate([self.low_fifo, head[bits == 0].ravel()])[-FIFO_LEN:]
        self.high_fifo = np.concatenate([self.high_fifo, head[bits == 1].ravel()])[-FIFO_LEN:]
        v11, v244 = float(np.median(self.low_fifo)), float(np.median(self.high_fifo))
        span = (v244 - v11) / (244.0 - 11.0)
        self.low = v11 - span * 11.0
        self.high = v11 - span * (11.0 - 255.0)

    def wedge(self, sa, sb):
        self.corr_pix = (self.corr_pix + [255.0 * (sa - self.low) / (self.high - self.low)])[-3:]
        self.corr_sig = (self.corr_sig + [sa])[-3:]
        self.corr_sig2 = (self.corr_sig2 + [sb])[-3:]
        pix, sig = float(np.median(self.corr_pix)), float(np.median(self.corr_sig))
        self.chid1 = (self.chid1 + [float(np.median(self.corr_sig2))])[-100:]
        self.chid2 = (self.chid2 + [sig])[-100:]
        if self.last_pix is None or abs(pix - self.last_pix) > 255.0 / 16:
            if self.state == 0 and self.last_sig is not None:
                self.wedge_pix, self.wedge_sig = [self.last_pix, pix], [self.last_sig, sig]
                self.state = 1
            elif 1 <= self.state <= 6:
                if pix - self.wedge_pix[-1] > 2 * 255.0 / 24:
                    self.wedge_pix.append(pix)
                    self.wedge_sig.append(sig)
                    self.state += 1
                else:
                    self.state = 0
            elif self.state == 7:
                if self.wedge_pix[-1] - pix > 2 * 255.0 / 3:
                    xs = np.asarray([sig] + self.wedge_sig)
                    ys = np.arange(9) * 255.0 / 8
                    dx = xs - xs.mean()
                    self.slope = float(np.dot(dx, ys - ys.mean()) / np.dot(dx, dx))
                    self.intercept = float(ys.mean() - self.slope * xs.mean())
                    self.locks += 1
                    self.chid1, self.chid2 = [], []
                self.state = 0
        self.last_pix, self.last_sig = pix, sig


def _quantize(line, scale, offset):
    return np.clip(np.round(line * scale + offset), 0, 255).astype(np.uint8)


def zero_phase_iir(x: torch.Tensor, sos: np.ndarray, prec: Precision,
                   tol: float = 1e-13) -> torch.Tensor:
    """filtfilt of the IIR `sos` over 1-D x, padded with the odd extension
    of 3 (2 n_sections + 1) samples, each pass from the steady state of its
    first sample (scipy's `sosfiltfilt`). At fp64 it is scipy's; the
    control applies each pass as the filter's impulse response, cut below
    `tol` of its peak, with the operands rounded to TF32 (a constant past
    input is the steady state the IIR pass starts from)."""
    if prec.name == "fp64":
        y = scipy.signal.sosfiltfilt(sos, x.double().cpu().numpy(),
                                     padlen=3 * (2 * len(sos) + 1))
        return torch.as_tensor(np.ascontiguousarray(y), device=x.device)
    n_imp = 1 << 12
    while True:
        imp = np.zeros(n_imp)
        imp[0] = 1.0
        h = scipy.signal.sosfilt(sos, imp)
        big = np.flatnonzero(np.abs(h) >= tol * np.abs(h).max())
        if big[-1] < n_imp // 2:
            h = h[:big[-1] + 1]
            break
        n_imp *= 2
    pad = 3 * (2 * len(sos) + 1)
    n = x.shape[0]
    v = x.to(prec.real)
    ext = torch.cat([2 * v[:1] - v[1:pad + 1].flip(0), v,
                     2 * v[-1:] - v[-pad - 1:-1].flip(0)])

    def causal(u):
        past = u[:1].expand(len(h) - 1)
        return prec.conv(torch.cat([past, u]), h[::-1].copy())

    return causal(causal(ext).flip(0)).flip(0)[pad:pad + n]


def image(audio: torch.Tensor, rate: int, sync_a, sync_b,
          prec: Precision | None = None) -> tuple[np.ndarray, int]:
    """The calibrated image from the audio and the crude syncs, and the
    number of times the wedge walk fitted its calibration."""
    prec = prec or Precision("fp64")
    n_env = int(audio.shape[0])
    # the syncs' rate is the audio's here, but the decoder rescales them
    # all the same: x / r * r is not always x in floating point, and int()
    # of the result then starts a line one sample early
    csync_a = np.asarray(sync_a, np.float64) / rate * rate
    csync_b = np.asarray(sync_b, np.float64) / rate * rate
    ucsync = set(float(u) for u in csync_a)
    csync_a = fill_syncs(csync_a, n_env)
    csync_b = fill_syncs(csync_b, n_env)
    if csync_b and csync_a and csync_b[0] < csync_a[0]:
        csync_b.pop(0)
    if csync_b and csync_a and csync_b[-1] < csync_a[-1]:
        csync_a.pop(-1)
    if len(csync_a) != len(csync_b):
        csync_b = list(np.asarray(csync_a) + int(0.25 * rate))

    sos = scipy.signal.butter(6, [400 / (0.5 * rate), 4400 / (0.5 * rate)],
                              btype="bandpass", output="sos")
    env = envelope_blocked(zero_phase_iir(audio, sos, prec), AM_BLOCK).cpu().numpy()
    num_pixels = int(0.5 / T_WORD)
    unit = num_pixels // 2
    kk = env.shape[0] // num_pixels
    probe = np.median(env[:kk * num_pixels].reshape(num_pixels, kk), axis=-1)
    strip_len = int(len(SYNCA) * T_WORD * rate)

    n_lines = len(csync_a)
    spans_a, spans_b, keep = [], [], []
    for i in range(n_lines):
        sa, sb = int(csync_a[i]), int(csync_b[i])
        ea, eb = sb, sb + int(0.25 * rate)
        if i + 1 < n_lines:
            eb = int(csync_a[i + 1])
        if eb > n_env or ea > n_env or sa < 0 or sb < 0:
            continue
        keep.append(i)
        spans_a.append((sa, ea))
        spans_b.append((sb, eb))

    def strip(s):
        if s >= strip_len:
            return float(np.median(env[s - strip_len:s]))
        return float(np.median(env[:s])) if s > 0 else 0.0

    def line_mats(spans):
        out = []
        for s, e in spans:
            ln = max(e - s, 0)
            k = ln // unit
            if k == 0:
                out.append((np.zeros(0), np.zeros((len(SYNCA), 0))))
                continue
            m = scipy.signal.resample(env[s:s + ln], k * unit).reshape(unit, k)
            out.append((np.median(m, axis=-1), m[:len(SYNCA)]))
        return out

    mats_a, mats_b = line_mats(spans_a), line_mats(spans_b)
    low, high = np.percentile(probe, (0.5, 99.5))
    calib = _Calib(float(low), float(high))
    img, backup, buffered = [], [], []
    for li, i in enumerate(keep):
        (med_a, head_a), (med_b, _) = mats_a[li], mats_b[li]
        if float(csync_a[i]) in ucsync and head_a.shape[1] > 0:
            calib.from_sync_train(head_a)
        calib.wedge(strip(spans_a[li][0]), strip(spans_b[li][0]))
        line = np.concatenate([med_a, med_b])
        if calib.slope is None:
            buffered.append(line)
            sc = 255.0 / (calib.high - calib.low)
            backup.append(_quantize(line, sc, -calib.low * sc))
        else:
            img += [_quantize(b, calib.slope, calib.intercept) for b in buffered]
            buffered = []
            img.append(_quantize(line, calib.slope, calib.intercept))
    if not img:
        img = backup
    lens = [len(r) for r in img]
    if not lens:
        return np.zeros((0, num_pixels), np.uint8), calib.locks
    accepted = max(set(lens), key=lens.count)
    return np.asarray([r for r in img if len(r) == accepted]), calib.locks


# ----------------------------------------------------------------- accurate sync

def accurate_sync(raw: torch.Tensor, fs: int, offset: float, sync_a, sync_b,
                  sync_rate: int, prec: Precision) -> list:
    """[syncA, diff, qualityA, timeA, syncB, diff, qualityB, timeB]: in a
    window of 3 sync lengths either side of each crude sync, at the full
    rate, the correlation maximum if it clears the window's top-2 /
    bottom-2 threshold, its value, and the envelope mean over the needle's
    length after it."""
    n = raw.shape[0] // 2
    width = int(3 * T_WORD * len(SYNCA) * fs)
    n_win = 2 * width
    bh, hm = blackmanharris(151), hamming(492)
    step = torch.arange(n_win, dtype=torch.float64, device=raw.device) \
        * (-2.0 * np.pi * offset / fs)
    rot = torch.polar(torch.ones_like(step), step).to(prec.cplx)
    out = []
    for bits, syncs in ((SYNCA, sync_a), (SYNCB, sync_b)):
        nd = torch.as_tensor(needle(bits, fs), dtype=prec.real, device=raw.device)
        ln = nd.shape[0]
        centers = np.asarray(syncs, np.float64) / sync_rate * fs
        starts = [int(c) - width for c in centers
                  if int(c) - width >= 0 and int(c) + width <= n]
        found = []
        for g in range(0, len(starts), WINDOW_GROUP):
            gs = starts[g:g + WINDOW_GROUP]
            idx = torch.as_tensor(gs, dtype=torch.int64, device=raw.device)
            rows = raw.unfold(0, 2 * n_win, 2)[idx].to(prec.real) - 127.5
            x = torch.complex(rows[:, 0::2], rows[:, 1::2]) * rot[None, :]
            f = fir_zero_phase(x, bh, prec)
            d = torch.angle(f[:, 1:] * f[:, :-1].conj())
            env = envelope(d)
            cor = norm_correlate(fir_zero_phase(env, hm, prec), nd)
            thr = adaptive_threshold(cor, fs)
            mx, am = torch.max(cor, dim=-1)
            p = am - ln // 2
            m = cor.shape[1]
            ts0 = torch.clamp(p + ln, 0, m - ln)
            ts = env.unfold(1, ln, 1)[torch.arange(env.shape[0], device=env.device),
                                      ts0].mean(dim=-1)
            has, p, mx, ts = (t.cpu().numpy() for t in (mx > thr, p, mx, ts))
            found += [(int(p[r]) + s0, float(mx[r]),
                       float(ts[r]) if p[r] + 2 * ln < m else None)
                      for r, s0 in enumerate(gs) if has[r]]
        da = [f[0] for f in found]
        out += [da, list(np.diff(da)), [f[1] for f in found], [f[2] for f in found]]
    return out


def front(raw: torch.Tensor, cfg: dict, precision: str = "fp64") -> dict:
    """The reference's FM audio and crude syncs from the bytes `raw` (on
    any device): {"audio", "rate", "sync_a", "sync_b", "cor_a", "cor_b",
    "half", "useful"}, the correlations indexed by sync + `half`."""
    prec = Precision(precision)
    fs, off = int(cfg["sample_rate"]), float(cfg["offset_hz"])
    bw, ntaps = int(cfg["fm_bandwidth_hz"]), int(cfg["frontend_taps"])
    audio = fm_audio(raw, fs, off, bw, ntaps, prec)
    rate = int(fs / (fs // bw))
    (sa, sb), (ca, cb) = crude_sync(audio.double() if precision == "fp64" else audio,
                                    rate)
    return {"audio": audio, "rate": rate, "sync_a": sa, "sync_b": sb,
            "cor_a": ca, "cor_b": cb, "half": len(needle(SYNCA, rate)) // 2,
            "useful": useful(sa, sb, rate), "precision": precision}


def products(raw: torch.Tensor, cfg: dict, fr: dict, sync_a, sync_b) -> dict:
    """The image and the accurate syncs from the front end `fr` (of
    `front`) with its lines cut at the crude syncs `sync_a`, `sync_b`: the
    reference's own, or the decode's where they are the reference's own up
    to float32 ties, as the driver judges them."""
    prec = Precision(fr["precision"])
    audio = fr["audio"].double() if prec.name == "fp64" else fr["audio"]
    fs, off = int(cfg["sample_rate"]), float(cfg["offset_hz"])
    img, locks = image(audio, fr["rate"], sync_a, sync_b, prec)
    return {"image": img, "locks": locks,
            "accurate": accurate_sync(raw, fs, off, sync_a, sync_b, fr["rate"], prec)}


def decode(raw: torch.Tensor, cfg: dict, precision: str = "fp64") -> dict:
    """The whole reference decode of the bytes `raw`: `front` and then
    `products` at its own crude syncs."""
    fr = front(raw, cfg, precision)
    return {**fr, **products(raw, cfg, fr, fr["sync_a"], fr["sync_b"])}
