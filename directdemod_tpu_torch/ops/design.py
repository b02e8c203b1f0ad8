"""Host-side filter design (pure NumPy, float64).

Copy of `directdemod_tpu/ops/design.py`: the Blackman-Harris, Hamming and
Gaussian windows, the boxcar, the Butterworth (b, a), zeros/poles/gain and
second-order sections, the Remez (Parks-McClellan) exchange with its
least-squares fallback, `lfilter_zi`, `lfiltic` and
`step_history_equivalent`. The JAX package cannot be imported without
importing jax, so the port carries its own copy; tests hold it equal to the
reference.
"""
from __future__ import annotations

import logging

import numpy as np

log = logging.getLogger(__name__)


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


def gaussian(n: int, sigma: float) -> np.ndarray:
    """Gaussian window centered on (n-1)/2 (matches scipy.signal.windows.gaussian)."""
    k = np.arange(n, dtype=np.float64) - (n - 1) / 2.0
    return np.exp(-0.5 * (k / float(sigma)) ** 2)


def rolling_average(n: int) -> np.ndarray:
    """Boxcar taps 1/n (ref filters.py:114)."""
    return np.full(n, 1.0 / n, dtype=np.float64)


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


def butter(order: int, wn, btype: str = "lowpass") -> tuple[np.ndarray, np.ndarray]:
    """Digital Butterworth (b, a) via the bilinear transform of the analog
    prototype; `wn` is normalized to Nyquist (scalar for lowpass/highpass,
    a pair for bandpass/bandstop), as scipy.signal.butter takes it."""
    zd, pd, kd = butter_zpk(order, wn, btype)
    b = np.real(_poly_from_roots(zd)) * kd
    a = np.real(_poly_from_roots(pd))
    return b, a


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


# --------------------------------------------------------------------------- Remez

def remez(numtaps: int, bands, desired, fs: float = 1.0,
          weight=None, maxiter: int = 250) -> np.ndarray:
    """Multiband equiripple FIR design (type I/II linear phase).

    Same calling convention as the subset of scipy.signal.remez used at ref
    filters.py:314 (`remez(ntaps, flat_band_edges_hz, gains, Hz=Fs)`),
    including the reference's even default ntaps=128.

    The native Parks-McClellan exchange (`_remez_pm`) converges across the
    reference's usage envelope (tests/test_design.py pins odd/even taps,
    1-5 bands, weighted specs); the SciPy fallback is reachable only for
    degenerate over-parameterized specs (far more taps than the occupied
    bandwidth supports), where SciPy's own exchange diverges too — we return
    its result there for behavioral parity with the reference, with a
    warning. The final fallback is a weighted least-squares design for when
    SciPy is absent.
    """
    try:
        h = _remez_pm(numtaps, bands, desired, fs=fs, weight=weight, maxiter=maxiter)
        if np.all(np.isfinite(h)) and _band_spec_ok(h, bands, desired, fs):
            return h
        log.warning("remez: native PM result violates the band spec "
                    "(degenerate over-parameterized design?); falling back")
    except Exception as e:
        log.warning("remez: native PM failed (%s); falling back", e)
    # SciPy fallback — but VALIDATE it: scipy.signal.remez silently returns
    # astronomically diverged coefficients on over-parameterized specs (e.g.
    # 129 taps over bands occupying 15% of Nyquist: max|H| ~ 1e32), so its
    # result cannot be trusted unchecked.
    try:
        import scipy.signal as _ss
        h = _ss.remez(numtaps, bands, desired, weight=weight, fs=fs)
        if np.all(np.isfinite(h)) and _band_spec_ok(h, bands, desired, fs):
            return h
        log.warning("remez: scipy result also violates the band spec; "
                    "using regularized least-squares design")
    except Exception:
        pass
    return _firls_multiband(numtaps, bands, desired, fs=fs, weight=weight)


def _band_spec_ok(h, bands, desired, fs, tol: float = 0.15) -> bool:
    """Sanity check: response within `tol` of the target across each band."""
    bands = np.asarray(bands, dtype=np.float64) / fs
    desired = np.asarray(desired, dtype=np.float64)
    for i, gain in enumerate(desired):
        f = np.linspace(bands[2 * i], bands[2 * i + 1], 64)
        n = np.arange(len(h))
        resp = np.abs(np.exp(-2j * np.pi * np.outer(f, n)) @ h)
        if np.max(np.abs(resp - gain)) > tol * max(1.0, np.max(np.abs(desired))):
            return False
    return True


def _firls_multiband(numtaps: int, bands, desired, fs: float = 1.0,
                     weight=None) -> np.ndarray:
    """Weighted least-squares type-I multiband FIR (fallback when PM diverges).

    The don't-care (transition) regions are lightly regularized toward a
    linear interpolation between the neighboring band gains: the unweighted
    minimum-norm solution of an over-parameterized spec (the only specs that
    reach this fallback) rings to gains of ~1e5 between bands, which makes the
    filter useless in practice even though it meets the in-band spec exactly.
    A 1e-3 relative weight on the transition grid bounds the global response
    near the band gains while perturbing the in-band fit by <1e-6.
    """
    bands = np.asarray(bands, dtype=np.float64) / fs
    desired = np.asarray(desired, dtype=np.float64)
    nb = len(desired)
    weight = np.ones(nb) if weight is None else np.asarray(weight, dtype=np.float64)
    m = (numtaps - 1) // 2
    fgrid, dgrid, wgrid = [], [], []
    for i in range(nb):
        f = np.linspace(bands[2 * i], bands[2 * i + 1], max(16 * m // nb, 32))
        fgrid.append(f)
        dgrid.append(np.full(len(f), desired[i]))
        wgrid.append(np.full(len(f), weight[i]))
    # transition-band regularization grid (linear ramp between band gains;
    # flat extrapolation below the first band and above the last)
    w_reg = 1e-3 * float(np.min(weight))
    gaps = [(0.0, bands[0], desired[0], desired[0])] + \
        [(bands[2 * i + 1], bands[2 * i + 2], desired[i], desired[i + 1])
         for i in range(nb - 1)] + \
        [(bands[-1], 0.5, desired[-1], desired[-1])]
    for (f0, f1, g0, g1) in gaps:
        if f1 - f0 <= 1e-9:
            continue
        f = np.linspace(f0, f1, max(int(np.ceil((f1 - f0) * 32 * m)), 8))
        fgrid.append(f)
        dgrid.append(g0 + (g1 - g0) * (f - f0) / (f1 - f0))
        wgrid.append(np.full(len(f), w_reg))
    f = np.concatenate(fgrid)
    dsp = np.concatenate(dgrid)
    w = np.sqrt(np.concatenate(wgrid))
    basis = np.cos(2 * np.pi * np.outer(f, np.arange(m + 1)))
    coef, *_ = np.linalg.lstsq(basis * w[:, None], dsp * w, rcond=None)
    h = np.zeros(numtaps)
    h[m] = coef[0]
    h[m + 1:] = coef[1:] / 2.0
    h[:m] = coef[1:][::-1] / 2.0
    return h


def _bary_weights(xe: np.ndarray) -> np.ndarray:
    """Barycentric weights d_k = 1/prod(xe_k - xe_j), computed in log space
    and max-centered so the largest |d| is 1 (a common scale factor cancels
    in every barycentric ratio; without the centering, >~60 extremal points
    overflow float64)."""
    n = len(xe)
    logd = np.empty(n)
    sgn = np.empty(n)
    for k in range(n):
        diff = xe[k] - np.delete(xe, k)
        if np.any(diff == 0.0):
            raise FloatingPointError("coincident extremal frequencies")
        logd[k] = -np.sum(np.log(np.abs(diff)))
        sgn[k] = np.prod(np.sign(diff))
    return sgn * np.exp(logd - logd.max())


def _bary_eval(x: np.ndarray, xe: np.ndarray, d: np.ndarray,
               ce: np.ndarray) -> np.ndarray:
    """Evaluate the barycentric interpolant through (xe, ce) at points x."""
    dx = x[:, None] - xe[None, :]
    hit = np.abs(dx) < 1e-14
    t = d / np.where(hit, 1.0, dx)
    vals = (t @ ce) / t.sum(axis=1)
    i, k = np.nonzero(hit)
    vals[i] = ce[k]
    return vals


def _remez_pm(numtaps: int, bands, desired, fs: float = 1.0,
              weight=None, maxiter: int = 250) -> np.ndarray:
    """Parks-McClellan exchange on the Chebyshev (x = cos 2*pi*f) basis.

    Covers the reference's full usage envelope (ref filters.py:279-314):
    arbitrary non-overlapping multibands with per-band gains/weights, both
    odd numtaps (type I) and the reference's even default ntaps=128 (type II,
    via the standard A(f) = cos(pi f) P(cos 2 pi f) factorization, which
    turns the type-II problem into a type-I exchange with desired/Q and
    weight*Q).
    """
    bands = np.asarray(bands, dtype=np.float64) / fs  # -> [0, 0.5]
    desired = np.asarray(desired, dtype=np.float64)
    nb = len(desired)
    weight = np.ones(nb) if weight is None else \
        np.asarray(weight, dtype=np.float64)

    type2 = numtaps % 2 == 0
    if type2 and bands[-1] >= 0.5 and desired[-1] != 0.0:
        raise ValueError("type-II response is forced to 0 at fs/2")
    r = numtaps // 2 if type2 else (numtaps - 1) // 2 + 1   # basis functions
    next_ = r + 1                                           # extremals

    # dense grid over the bands, ~16 points per basis function distributed by
    # band width, band edges included exactly
    total_width = sum(bands[2 * i + 1] - bands[2 * i] for i in range(nb))
    grid, band_of = [], []
    for i in range(nb):
        f0, f1 = bands[2 * i], bands[2 * i + 1]
        npts = max(int(np.ceil((f1 - f0) / max(total_width, 1e-12) * 16 * r)),
                   16)
        g = np.linspace(f0, f1, npts)
        if type2:   # Q = cos(pi f) vanishes at 0.5; keep the grid off it
            g = g[g < 0.5 - 1e-9 / numtaps]
            if len(g) < 8:
                g = np.linspace(f0, min(f1, 0.5 - 1e-4), 8)
        grid.append(g)
        band_of.append(np.full(len(g), i))
    grid = np.concatenate(grid)
    band_of = np.concatenate(band_of)
    des = desired[band_of].copy()
    wt = weight[band_of].copy()
    if type2:
        q = np.cos(np.pi * grid)
        des = des / q
        wt = wt * q
    ng = len(grid)
    if ng <= next_:
        raise ValueError(f"grid too small: {ng} points for {next_} extremals")
    x_grid = np.cos(2 * np.pi * grid)

    # band spans as [start, end] grid-index pairs (for per-band peak search)
    starts = np.flatnonzero(np.r_[True, np.diff(band_of) != 0])
    ends = np.r_[starts[1:] - 1, ng - 1]

    ext = np.unique(np.round(np.linspace(0, ng - 1, next_)).astype(int))
    k = 1
    while len(ext) < next_:          # duplicates only when bands are tiny
        ext = np.unique(np.r_[ext, min(ext[-1] + k, ng - 1),
                              max(ext[0] - k, 0)])
        k += 1
    ext = ext[:next_]
    sign = (-1.0) ** np.arange(next_)

    def _solve(ext_idx):
        """delta + interpolant values ce on the extremal set."""
        xe = x_grid[ext_idx]
        d = _bary_weights(xe)
        de, we = des[ext_idx], wt[ext_idx]
        denom = np.sum(d * sign / we)
        if abs(denom) < 1e-300:
            raise FloatingPointError("degenerate extremal set")
        delta = np.sum(d * de) / denom
        ce = de - sign * delta / we
        return delta, xe, d, ce

    delta, xe, d, ce = _solve(ext)
    for _ in range(maxiter):
        err = wt * (des - _bary_eval(x_grid, xe, d, ce))
        # At the extremal nodes err equals sign_k * delta EXACTLY by
        # construction, but computing it as des - ce is catastrophic
        # cancellation (noise >> |delta| in early iterations, where delta is
        # near zero and interpolation bulges dominate). Overwriting with the
        # theoretical value keeps the current extremals a valid alternating
        # candidate skeleton, so the exchange can never collapse below
        # next_ alternations.
        err[ext] = sign * delta
        ae = np.abs(err)
        # candidate extremals: the current set plus per-band local maxima of
        # |err| (band edges qualify against their single in-band neighbor,
        # as in the classic McClellan-Parks-Rabiner search)
        cand = set(ext.tolist())
        for lo, hi in zip(starts, ends):
            for i in range(lo, hi + 1):
                if (i == lo or ae[i] > ae[i - 1]) and \
                        (i == hi or ae[i] >= ae[i + 1]):
                    cand.add(i)
        # compress same-sign runs (keep the largest |err| of each run)
        kept = []
        for i in sorted(cand):
            if kept and np.sign(err[i]) == np.sign(err[kept[-1]]):
                if ae[i] > ae[kept[-1]]:
                    kept[-1] = i
            else:
                kept.append(i)
        while len(kept) > next_:
            # alternation is intact: only endpoint removal preserves it
            if ae[kept[0]] <= ae[kept[-1]]:
                kept.pop(0)
            else:
                kept.pop()
        if len(kept) < next_:
            raise FloatingPointError(
                f"extremal set collapsed: {len(kept)} < {next_}")
        new_ext = np.asarray(kept)
        maxerr = ae.max()
        delta, xe, d, ce = _solve(new_ext)
        converged = np.array_equal(new_ext, ext) or \
            (maxerr - abs(delta)) <= 1e-6 * abs(delta)
        ext = new_ext
        if converged:
            break

    # Exact reconstruction: the optimum A(f) is band-limited to numtaps real
    # DFT degrees of freedom, so sampling it at k/numtaps and one IDFT of
    # H_k = A_k exp(-j pi k (numtaps-1)/numtaps) recovers h exactly.
    n = numtaps
    fk = np.arange(n // 2 + 1) / float(n)
    pk = _bary_eval(np.cos(2 * np.pi * fk), xe, d, ce)
    ak = pk * np.cos(np.pi * fk) if type2 else pk
    a_full = np.empty(n)
    a_full[: n // 2 + 1] = ak
    tail = ak[1: (n + 1) // 2][::-1]
    a_full[n // 2 + 1:] = -tail if type2 else tail   # A(1-f) = -/+ A(f)
    if type2:
        a_full[n // 2] = 0.0
    hk = a_full * np.exp(-1j * np.pi * np.arange(n) * (n - 1) / n)
    return np.fft.ifft(hk).real


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


def lfiltic(b, a, y, x=None) -> np.ndarray:
    """Initial DF2T state from past outputs y and past inputs x (matches
    scipy.signal.lfiltic)."""
    b = np.atleast_1d(np.asarray(b, dtype=np.float64))
    a = np.atleast_1d(np.asarray(a, dtype=np.float64))
    n = max(len(a), len(b))
    a = np.pad(a, (0, n - len(a)))
    b = np.pad(b, (0, n - len(b)))
    m = n - 1
    y = np.asarray(y)[:m]
    x = np.zeros(0) if x is None else np.asarray(x)[:m]
    zi = np.zeros(m, dtype=np.result_type(y.dtype, np.float64))
    for i in range(m):
        for k in range(i + 1, n):
            if k - i - 1 < len(x):
                zi[i] += b[k] * x[k - i - 1]
            if k - i - 1 < len(y):
                zi[i] -= a[k] * y[k - i - 1]
    return zi


def step_history_equivalent(ntaps: int) -> np.ndarray:
    """The FIR input history equivalent to seeding with `lfilter_zi`: for a
    pure FIR the step steady state is what an all-ones past input leaves,
    so the streams start their FIR histories at 1.0 (ref filters.py:45)."""
    return np.ones(ntaps - 1, dtype=np.float64)
