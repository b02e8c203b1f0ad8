"""The remaining peak-detection variants of the vendored billauer module.

Port of `directdemod_tpu/ops/peaks_extra.py:41-359`: `peakdetect_fft` /
`peakdetect_parabola` / `peakdetect_sine` / `peakdetect_sine_locked` /
`peakdetect_spline` / `peakdetect_zero_crossing` and their helpers `_smooth`
/ `zero_crossings` (ref peakdetect.py:257-766), analysis utilities with the
[max_peaks, min_peaks] -> [[x, y], ...] contract. No decoder calls them.

The smoothing, the zero crossings and the ragged bins between them are host
NumPy, copied from the JAX module. The dense work runs on `device` (the
port's device rule, `device.resolve`: None is the current CUDA device):

  * `peaks_fft` interpolates by a mid-spectrum zero pad (`torch.fft`,
    complex128) and walks the interpolated waveform with
    `ops.peaks.lookahead_peaks` at lookahead 500, which is K2
    (`csrc/lookahead_walk.cu`) on a CUDA tensor, in float32 as the TPU
    kernel walks;
  * the parabola and sine refinements are batched least-squares fits over
    all peak windows at once in float64 (a 3x3 solve; a 2x2 solve with 8
    damped Gauss-Newton steps on the frequency);
  * the cubic B-spline prefilter's two first-order recursions run as
    log-depth doubling scans (the form `ops.iir` uses for its block states)
    where the JAX module runs `lax.scan`.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..device import resolve
from .peaks import lookahead_peaks

_WINDOWS = {
    "flat": lambda n: np.ones(n, np.float64),
    "hanning": np.hanning,
    "hamming": np.hamming,
    "bartlett": np.bartlett,
    "blackman": np.blackman,
}


# --------------------------------------------------------------------- smoothing
def smooth(x, window_len: int = 11, window: str = "hanning") -> np.ndarray:
    """Reflected-end window smoothing (ref peakdetect.py:655-715): the signal
    is extended with mirrored copies at both ends and convolved with the
    normalized window; output length is len(x) + window_len - 1. Host NumPy,
    as `directdemod_tpu/ops/peaks_extra.py:51-69`."""
    x = np.asarray(x, dtype=np.float64)
    if x.ndim != 1:
        raise ValueError("smooth only accepts 1 dimension arrays.")
    if x.size < window_len:
        raise ValueError("Input vector needs to be bigger than window size.")
    if window_len < 3:
        return x
    if window not in _WINDOWS:
        raise ValueError(f"Window is not one of {sorted(_WINDOWS)}")
    w = _WINDOWS[window](window_len)
    ext = np.r_[x[window_len - 1:0:-1], x, x[-1:-window_len:-1]]
    # host conv: the sign-change detection downstream is bit-sensitive at
    # near-zero samples
    return np.convolve(w / w.sum(), ext, mode="valid")


# ----------------------------------------------------------------- zero crossings
def zero_crossings(y_axis, window_len: int = 11, window_f: str = "hanning",
                   offset_corrected: bool = False) -> np.ndarray:
    """Sign-change indices of the smoothed signal, with the reference's
    validity test and one-shot offset-correction recursion
    (ref peakdetect.py:718-766; the recursion smooths twice, as upstream).
    Host NumPy, as `directdemod_tpu/ops/peaks_extra.py:73-95`."""
    y = np.asarray(y_axis, dtype=np.float64)
    length = len(y)
    ys = smooth(y, window_len, window_f)[:length]
    indices = np.where(np.diff(np.sign(ys)))[0]

    diff = np.diff(indices)
    if diff.size and diff.std() / diff.mean() > 0.1:
        ev, od = diff[::2], diff[1::2]
        if (ev.size and od.size and not offset_corrected
                and ev.std() / ev.mean() < 0.1 and od.std() / od.mean() < 0.1):
            offset = np.mean([ys.max(), ys.min()])
            return zero_crossings(ys - offset, window_len, window_f, True)
        raise ValueError("False zero-crossings found, indicates problem "
                         "with smoothing window or unhandled offset")
    if len(indices) < 1:
        raise ValueError("No zero crossings found")
    return indices - (window_len // 2 - 1)


# ------------------------------------------------------------- zero-crossing bins
def peaks_zero_crossing(y_axis, x_axis=None, window: int = 11):
    """Max/min of alternating inter-crossing bins
    (ref peakdetect.py:580-652). Returns [max_peaks, min_peaks]. Host
    NumPy, as `directdemod_tpu/ops/peaks_extra.py:99-132`."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.arange(len(y)) if x_axis is None else np.asarray(x_axis)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")

    zc = zero_crossings(y, window_len=window)
    # the smoothing-delay shift can push the first crossing below 0: clip
    spans = [(max(int(s), 0), int(e)) for s, e in zip(zc, zc[1:])
             if e > max(int(s), 0)]
    even = spans[::2]
    odd = spans[1::2]

    def bin_max(spans):
        out = []
        for s, e in spans:
            k = s + int(np.argmax(y[s:e]))
            out.append([x[k], y[k]])
        return out

    def bin_min(spans):
        out = []
        for s, e in spans:
            k = s + int(np.argmin(y[s:e]))
            out.append([x[k], y[k]])
        return out

    s0, e0 = even[0]
    if abs(y[s0:e0].max()) > abs(y[s0:e0].min()):
        return [bin_max(even), bin_min(odd)]
    return [bin_max(odd), bin_min(even)]


# ----------------------------------------------------------------- FFT interpolation
def peaks_fft(y_axis, x_axis, pad_len: int = 20, device=None):
    """Zero-padded-FFT time-domain interpolation between the first and last
    zero crossing, then lookahead peak detection on the upsampled waveform
    (ref peakdetect.py:257-337): the interpolation and the walk (K2 on a
    card) run on `device`."""
    yi, xi, delta = _fft_waveform(y_axis, x_axis, pad_len, resolve(device))
    max_p, min_p = lookahead_peaks(yi, 500, delta)
    return [[[xi[int(i)], v] for i, v in max_p],
            [[xi[int(i)], v] for i, v in min_p]]


def _fft_waveform(y_axis, x_axis, pad_len: int, dev: torch.device):
    """What `peaks_fft` walks: (the interpolated waveform, float64 on dev;
    its x axis, host; the walk's delta)."""
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    zc = zero_crossings(y, window_len=11)
    last = -1 - (1 - len(zc) & 1)       # keep a whole number of periods
    seg = y[zc[0]:zc[last]]

    n_fft = len(seg)
    n_pad = 2 ** (int(np.log2(n_fft * pad_len)) + 1)
    yi = _fft_interp(torch.from_numpy(seg).to(dev), n_pad)
    xi = np.linspace(x[zc[0]], x[zc[last]], int(yi.shape[0]))
    return yi, xi, float(np.abs(np.diff(y)).max() * 2)


def _fft_interp(seg: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Mid-spectrum zero padding: X[:n/2] ++ zeros ++ X[n/2:], scaled by the
    length ratio (ref peakdetect.py:313-324), in complex128 on seg's
    device; returns the float64 real part."""
    n = seg.shape[0]
    f = torch.fft.fft(seg.to(torch.complex128))
    padded = torch.cat([f[: n // 2], f.new_zeros(n_pad - n), f[n // 2:]])
    return torch.fft.ifft(padded).real * (n_pad / n)


# ------------------------------------------------------------------ window gather
def _peak_windows(y: np.ndarray, x: np.ndarray, idx: np.ndarray, points: int):
    """Stack the `points`-wide windows around each raw peak index. Windows are
    clipped at the array ends (the reference slices, which silently shortens
    edge windows; clipping keeps them fixed-width for batching)."""
    half = points // 2
    offs = np.arange(-half, half + 1)
    cols = np.clip(idx[:, None] + offs[None, :], 0, len(y) - 1)
    return x[cols], y[cols]


def _fit_quadratic(xw: torch.Tensor, yw: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched closed-form LS quadratic fit; returns (vertex_x, vertex_y).
    Same optimum as the reference's curve_fit of a*(x-tau)**2+c
    (ref peakdetect.py:101-120) because that model is an overparametrized
    quadratic. Windows are mean-centered for conditioning."""
    x0 = xw.mean(dim=1, keepdim=True)
    xc = xw - x0
    V = torch.stack([xc * xc, xc, torch.ones_like(xc)], dim=-1)   # (B, P, 3)
    G = torch.einsum("bpi,bpj->bij", V, V)
    r = torch.einsum("bpi,bp->bi", V, yw)
    abc = torch.linalg.solve(G, r[..., None])[..., 0]              # a t^2 + b t + c
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    tau = -b / (2 * a)
    return tau + x0[:, 0], c - b * b / (4 * a)


def _windows_on(y, x, raw, points, dev):
    idx = np.asarray([int(p[0]) for p in raw])
    xw, yw = _peak_windows(y, x, idx, points)
    return torch.from_numpy(xw).to(dev), torch.from_numpy(yw).to(dev)


def peaks_parabola(y_axis, x_axis, points: int = 31, device=None):
    """Parabola-refined peaks: raw zero-crossing peaks, then a batched
    quadratic LS fit per window on `device` (ref peakdetect.py:340-391)."""
    dev = resolve(device)
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")
    points += 1 - points % 2
    max_raw, min_raw = peaks_zero_crossing(y)      # index-valued x
    out = []
    for raw in (max_raw, min_raw):
        px, pv = _fit_quadratic(*_windows_on(y, x, raw, points, dev))
        out.append([[a, b] for a, b in zip(px.tolist(), pv.tolist())])
    return out


# ----------------------------------------------------------------------- sine fits
def _fit_cosine(xw: torch.Tensor, yw: torch.Tensor, hz0: float, lock: bool,
                iters: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched fit of y = A sin(2 pi f (x - tau) + pi/2) == A cos(w (x - tau))
    (ref peakdetect.py:457-493). For fixed f the model is linear in
    (a, b) = (A cos(w tau), A sin(w tau)); unlocked mode refines f by
    `iters` damped Gauss-Newton steps on the shared-frequency residual per
    window. Returns (tau, signed amplitude)."""
    def solve_ab(w):
        c = torch.cos(w[:, None] * xw)
        s = torch.sin(w[:, None] * xw)
        g11 = (c * c).sum(dim=1)
        g12 = (c * s).sum(dim=1)
        g22 = (s * s).sum(dim=1)
        r1 = (c * yw).sum(dim=1)
        r2 = (s * yw).sum(dim=1)
        det = g11 * g22 - g12 * g12
        return (g22 * r1 - g12 * r2) / det, (g11 * r2 - g12 * r1) / det

    w = torch.full((xw.shape[0],), 2 * math.pi * hz0, dtype=xw.dtype,
                   device=xw.device)
    if not lock:
        for _ in range(iters):
            a, b = solve_ab(w)
            cw, sw = torch.cos(w[:, None] * xw), torch.sin(w[:, None] * xw)
            resid = yw - (a[:, None] * cw + b[:, None] * sw)
            dm_dw = xw * (-a[:, None] * sw + b[:, None] * cw)
            num = (dm_dw * resid).sum(dim=1)
            den = (dm_dw * dm_dw).sum(dim=1) + 1e-12
            w = w + 0.5 * num / den
    a, b = solve_ab(w)
    amp = torch.hypot(a, b)
    phase = torch.atan2(b, a)                 # y = amp cos(w x - phase)
    # tau = nearest extremum of the fitted cosine to the window center
    xc = xw[:, xw.shape[1] // 2]
    k = torch.round((w * xc - phase) / math.pi)
    tau = (phase + math.pi * k) / w
    sign = torch.where(torch.remainder(k, 2) == 0, 1.0, -1.0).to(amp.dtype)
    return tau, sign * amp


def peaks_sine(y_axis, x_axis, points: int = 31, lock_frequency: bool = False,
               device=None):
    """Sine-model-refined peaks (ref peakdetect.py:394-514): global offset
    from the raw peak means, frequency seeded from raw peak spacing, batched
    cosine LS fit per window on `device`; returns [[tau, A + offset], ...]
    per polarity (A carries the minima's negative sign, as upstream)."""
    dev = resolve(device)
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")
    points += 1 - points % 2
    max_raw, min_raw = peaks_zero_crossing(y)
    offset = np.mean([np.mean([p[1] for p in max_raw]),
                      np.mean([p[1] for p in min_raw])])
    # raw peak spacing -> frequency seed, in x units
    dx = np.mean([np.mean(np.diff([x[int(p[0])] for p in max_raw])),
                  np.mean(np.diff([x[int(p[0])] for p in min_raw]))])
    hz0 = float(1.0 / dx)

    out = []
    for raw in (max_raw, min_raw):
        xw, yw = _windows_on(y, x, raw, points, dev)
        px, pa = _fit_cosine(xw, yw - float(offset), hz0, bool(lock_frequency))
        out.append([[a, b + float(offset)]
                    for a, b in zip(px.tolist(), pa.tolist())])
    return out


def peaks_sine_locked(y_axis, x_axis, points: int = 31, device=None):
    """peaks_sine with the frequency locked to the raw estimate
    (ref peakdetect.py:517-531)."""
    return peaks_sine(y_axis, x_axis, points, True, device=device)


# ------------------------------------------------------------------ cubic spline
_SPLINE_POLE = float(np.sqrt(3.0) - 2.0)


def _first_order_scan(u: torch.Tensor, z: float) -> torch.Tensor:
    """c[0] = u[0], c[i] = u[i] + z c[i-1], as a Hillis-Steele doubling
    scan: after the round with shift d, c[i] holds the sum over its last 2d
    inputs, each weighted by the matching power of z. Stops once z^d
    underflows to 0, past which a round adds exact zeros."""
    g = u
    p = z
    d = 1
    while d < g.shape[0] and p != 0.0:
        g = torch.cat([g[:d], g[d:] + p * g[:-d]])
        p *= p
        d *= 2
    return g


def _cspline_coeffs(y: torch.Tensor) -> torch.Tensor:
    """Cubic B-spline prefilter (mirror-symmetric), the analog of scipy's
    cspline1d used by the reference (ref peakdetect.py:572): causal +
    anticausal first-order recursions with exact mirror inits, in y's
    dtype and on its device."""
    z = _SPLINE_POLE
    n = y.shape[0]
    # causal init with the full-length mirror sum (scipy's exact form)
    pows = z ** torch.arange(n, dtype=y.dtype, device=y.device)
    c0 = y[0] + z * torch.dot(pows, y)
    cp = _first_order_scan(torch.cat([c0[None], y[1:]]), z)
    # anticausal: cm[n-1] = z/(z-1) cp[n-1], cm[k] = z (cm[k+1] - cp[k]),
    # walked as a causal scan over the reversed sequence
    cN = (z / (z - 1.0)) * cp[-1]
    cm = _first_order_scan(torch.cat([cN[None], -z * cp[:-1].flip(0)]), z)
    return cm.flip(0) * 6.0


def _cspline_eval(coeffs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Evaluate sum_k c[k] beta3(u - k) with mirror-symmetric coefficient
    extension; u is in (fractional) sample units."""
    n = coeffs.shape[0]
    base = torch.floor(u).long()
    acc = torch.zeros_like(u)
    for off in (-1, 0, 1, 2):
        k = (base + off).abs()
        # mirror-symmetric index fold into [0, n-1]
        k = torch.where(k > n - 1, 2 * (n - 1) - k, k).clamp(0, n - 1)
        t = (u - (base + off).to(u.dtype)).abs()
        b3 = torch.where(t < 1.0, 2.0 / 3.0 - t * t + 0.5 * t ** 3,
                         torch.where(t < 2.0, ((2.0 - t) ** 3) / 6.0, 0.0))
        acc = acc + coeffs[k] * b3
    return acc


def peaks_spline(y_axis, x_axis, pad_len: int = 20, device=None):
    """B-spline-interpolated zero-crossing peaks (ref peakdetect.py:534-577):
    resolution is raised (pad_len+1)x by evaluating the cubic spline on a
    dense grid on `device`, then binned extrema between crossings."""
    dev = resolve(device)
    y = np.asarray(y_axis, dtype=np.float64)
    x = np.asarray(x_axis, dtype=np.float64)
    if len(x) != len(y):
        raise ValueError("Input vectors y_axis and x_axis must have same length")
    dx = x[1] - x[0]
    xi = np.linspace(x.min(), x.max(), len(x) * (pad_len + 1))
    u = (xi - x[0]) / dx
    coeffs = _cspline_coeffs(torch.from_numpy(y).to(dev))
    yi = _cspline_eval(coeffs, torch.from_numpy(u).to(dev)).cpu().numpy()
    return peaks_zero_crossing(yi, xi)
