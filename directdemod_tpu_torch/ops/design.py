"""Host-side filter design (pure NumPy, float64).

Copy of the subset of `directdemod_tpu/ops/design.py` the NOAA path needs
(lines 28-183 and 460-484 there): the Blackman-Harris and Hamming windows,
the Butterworth zeros/poles/gain and second-order sections, and
`lfilter_zi`. The JAX package cannot be imported without importing jax, so
the port carries its own copy; tests hold it equal to the reference.
"""
from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------- windows

def _cosine_window(n: int, coeffs) -> np.ndarray:
    """Generalized symmetric cosine window: sum_k (-1)^k a_k cos(2 pi k t)."""
    if n == 1:
        return np.ones(1)
    t = np.arange(n, dtype=np.float64) / (n - 1)
    w = np.zeros(n, dtype=np.float64)
    for k, a in enumerate(coeffs):
        w += ((-1) ** k) * a * np.cos(2.0 * np.pi * k * t)
    return w


def blackmanharris(n: int) -> np.ndarray:
    """4-term Blackman-Harris window (matches scipy.signal.windows.blackmanharris)."""
    return _cosine_window(n, (0.35875, 0.48829, 0.14128, 0.01168))


def hamming(n: int) -> np.ndarray:
    """Hamming window (matches scipy.signal.windows.hamming, sym=True)."""
    return _cosine_window(n, (0.54, 0.46))


# --------------------------------------------------------------------------- Butterworth

def _butter_analog_poles(order: int) -> np.ndarray:
    """Poles of the normalized analog Butterworth prototype (cutoff 1 rad/s)."""
    k = np.arange(1, order + 1)
    theta = np.pi * (2 * k - 1) / (2 * order) + np.pi / 2
    return np.exp(1j * theta)


def _poly_from_roots(roots: np.ndarray) -> np.ndarray:
    p = np.array([1.0 + 0j])
    for r in roots:
        p = np.convolve(p, np.array([1.0, -r]))
    return p


def butter_zpk(order: int, wn, btype: str = "lowpass"):
    """Digital Butterworth zeros/poles/gain via the bilinear transform of the
    analog prototype; `wn` is normalized to Nyquist (scipy's convention)."""
    fs = 2.0
    warped = 2.0 * fs * np.tan(np.pi * np.asarray(wn, dtype=np.float64) / fs)

    poles = _butter_analog_poles(order)
    zeros = np.array([], dtype=complex)
    gain = 1.0  # prototype gain: prod(-poles) = 1 for Butterworth

    if btype in ("lowpass", "low", "lp"):
        w0 = float(warped)
        zeros_t, poles_t = zeros, poles * w0
        gain_t = gain * w0 ** order
    elif btype in ("highpass", "high", "hp"):
        w0 = float(warped)
        zeros_t = np.zeros(order, dtype=complex)
        poles_t = w0 / poles
        gain_t = gain / np.real(np.prod(-poles))
    elif btype in ("bandpass", "bp"):
        w1, w2 = float(warped[0]), float(warped[1])
        bw, w0 = w2 - w1, np.sqrt(w1 * w2)
        disc = np.sqrt((poles * bw / 2) ** 2 - w0 ** 2 + 0j)
        poles_t = np.concatenate([poles * bw / 2 + disc, poles * bw / 2 - disc])
        zeros_t = np.zeros(order, dtype=complex)
        gain_t = gain * bw ** order
    elif btype in ("bandstop", "bs"):
        w1, w2 = float(warped[0]), float(warped[1])
        bw, w0 = w2 - w1, np.sqrt(w1 * w2)
        inv = bw / 2 / poles
        disc = np.sqrt(inv ** 2 - w0 ** 2 + 0j)
        poles_t = np.concatenate([inv + disc, inv - disc])
        zeros_t = np.concatenate([1j * w0 * np.ones(order), -1j * w0 * np.ones(order)])
        gain_t = gain
    else:
        raise ValueError(f"unknown btype {btype!r}")

    # bilinear transform s -> 2*fs*(z-1)/(z+1)
    fs2 = 2.0 * fs
    zd = (fs2 + zeros_t) / (fs2 - zeros_t) if zeros_t.size else np.array([], dtype=complex)
    pd = (fs2 + poles_t) / (fs2 - poles_t)
    # zeros at infinity map to z = -1
    n_inf = len(pd) - len(zd)
    zd = np.concatenate([zd, -np.ones(n_inf, dtype=complex)])
    kd = gain_t * np.real(np.prod(fs2 - zeros_t) / np.prod(fs2 - poles_t))
    return zd, pd, kd


def butter_sos(order: int, wn, btype: str = "lowpass") -> np.ndarray:
    """Digital Butterworth as second-order sections, shape (ns, 6).

    Conjugate pole pairs are matched with zero pairs; the overall gain rides on
    the first section.
    """
    z, p, k = butter_zpk(order, wn, btype)
    # sort poles: nearest the unit circle first (process hardest sections first)
    p = np.asarray(sorted(p, key=lambda x: -np.abs(x)))
    z = np.asarray(sorted(z, key=lambda x: -np.abs(x)))

    def take_pair(arr):
        """Pop a conjugate (or two real) root pair from arr."""
        if len(arr) == 0:
            return np.array([], dtype=complex), arr
        r = arr[0]
        rest = list(arr[1:])
        if abs(r.imag) > 1e-12:
            j = int(np.argmin(np.abs(np.asarray(rest) - np.conj(r))))
            pair = np.array([r, rest.pop(j)])
        elif rest:
            reals = [i for i, q in enumerate(rest) if abs(q.imag) <= 1e-12]
            j = reals[0] if reals else 0
            pair = np.array([r, rest.pop(j)])
        else:
            pair = np.array([r])
        return pair, np.asarray(rest)

    sections = []
    pz, zz = p, z
    while len(pz):
        pp, pz = take_pair(pz)
        zp, zz = take_pair(zz)
        bs = np.real(_poly_from_roots(zp))
        as_ = np.real(_poly_from_roots(pp))
        bs = np.pad(bs, (0, 3 - len(bs)))
        as_ = np.pad(as_, (0, 3 - len(as_)))
        sections.append(np.concatenate([bs, as_]))
    sos = np.asarray(sections, dtype=np.float64)
    sos[0, :3] *= k
    return sos


# --------------------------------------------------------------------------- initial conditions

def lfilter_zi(b, a) -> np.ndarray:
    """Steady-state direct-form-II-transposed state for a unit-step input
    (matches scipy.signal.lfilter_zi)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    while len(a) > 1 and a[0] == 0.0:
        a = a[1:]
    if a[0] != 1.0:
        b = b / a[0]
        a = a / a[0]
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    A = np.zeros((n - 1, n - 1))
    A[:, 0] = -a[1:]
    A[:-1, 1:] = np.eye(n - 2)
    B = b[1:] - a[1:] * b[0]
    return np.linalg.solve(np.eye(n - 1) - A, B)
