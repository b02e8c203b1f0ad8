"""The port's peak-detection variants (`directdemod_tpu_torch.ops.
peaks_extra`) against the JAX module's (`directdemod_tpu.ops.peaks_extra`,
x64, on the CPU, where its walk is the `lax.scan` path) on the same seeded
inputs, at the sizes of tests/test_peaks_extra.py (300-3,000 samples, 3-8
periods), the port with `device="cpu"`.

Stated tolerances:
- `smooth`, `zero_crossings` and `peaks_zero_crossing` are the same host
  NumPy on both sides: equal;
- `peaks_fft`: the same peak count, positions within 1e-3 in x units (the
  interpolated grid: the port walks in float32 as K2 does, the JAX scan
  in float64 under x64), values within 1e-6;
- `peaks_parabola`, `peaks_sine`, `peaks_sine_locked`: within 1e-9, and the
  sine variants also against the JAX file's analytic ground truth;
- `_cspline_coeffs` (a doubling scan in the port, `lax.scan` in JAX):
  within 1e-9 of JAX and of `scipy.signal.cspline1d`; `peaks_spline`
  within 1e-8;
- the ValueErrors on a short input, a bad window and mismatched x and y
  carry JAX's messages.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.signal import cspline1d

from directdemod_tpu.ops import peaks_extra as jpx
from directdemod_tpu_torch.ops import peaks, peaks_extra as px

torch.set_num_threads(1)

WINDOWS = ["flat", "hanning", "hamming", "bartlett", "blackman"]


def _sine(n=2000, periods=8.0, offset=0.0, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, n, endpoint=False)
    y = np.sin(2 * np.pi * periods * x) + offset + noise * rng.standard_normal(n)
    return x, y


def _close(ours, theirs, atol):
    for o, t in zip(ours, theirs):
        o, t = np.asarray(o, dtype=float), np.asarray(t, dtype=float)
        assert o.shape == t.shape and len(o) > 0
        np.testing.assert_allclose(o, t, rtol=0, atol=atol)


@pytest.mark.parametrize("window", WINDOWS)
def test_smooth_matches_jax(window):
    _, y = _sine(300, 3.0, noise=0.05)
    assert np.array_equal(px.smooth(y, 11, window), jpx.smooth(y, 11, window))


@pytest.mark.parametrize("offset,noise", [(0.0, 0.02), (0.9, 0.0)])
def test_zero_crossings_matches_jax(offset, noise):
    """Plain, and with a DC offset that takes the offset-corrected branch."""
    _, y = _sine(2000, 8.0, offset=offset, noise=noise)
    got = px.zero_crossings(y)
    assert np.array_equal(got, jpx.zero_crossings(y)) and len(got) > 0


def test_peaks_zero_crossing_matches_jax():
    x, y = _sine(2000, 8.0, noise=0.02)
    ours, theirs = px.peaks_zero_crossing(y, x), jpx.peaks_zero_crossing(y, x)
    for o, t in zip(ours, theirs):
        assert np.array_equal(np.asarray(o, float), np.asarray(t, float))


@pytest.mark.parametrize("n,periods,noise", [(1200, 5.0, 0.0), (2000, 8.0, 0.01),
                                             (3000, 6.0, 0.0)])
def test_peaks_fft_matches_jax(n, periods, noise):
    x, y = _sine(n, periods, noise=noise)
    ours, theirs = px.peaks_fft(y, x, device="cpu"), jpx.peaks_fft(y, x)
    for o, t in zip(ours, theirs):
        o, t = np.asarray(o, dtype=float), np.asarray(t, dtype=float)
        assert o.shape == t.shape and len(o) >= periods - 2
        np.testing.assert_allclose(o[:, 0], t[:, 0], rtol=0, atol=1e-3)
        np.testing.assert_allclose(o[:, 1], t[:, 1], rtol=0, atol=1e-6)


def test_peaks_fft_walks_lookahead_peaks_at_500(monkeypatch):
    """The walk is `ops.peaks.lookahead_peaks` at lookahead 500 on the
    interpolated waveform (K2 on a CUDA tensor)."""
    seen = []

    def spy(yi, lookahead, delta=0.0):
        seen.append((yi.dtype, yi.device.type, int(yi.shape[0]), lookahead))
        return peaks.lookahead_peaks(yi, lookahead, delta)
    monkeypatch.setattr(px, "lookahead_peaks", spy)
    x, y = _sine(1200, 5.0)
    px.peaks_fft(y, x, device="cpu")
    assert seen == [(torch.float64, "cpu", 32768, 500)]


def test_fft_interp_matches_jax():
    _, y = _sine(1000, 4.0, noise=0.01)
    got = px._fft_interp(torch.from_numpy(y), 16384).numpy()
    np.testing.assert_allclose(got, np.asarray(jpx._fft_interp(jnp.asarray(y), 16384)),
                               rtol=0, atol=1e-12)


def test_peaks_parabola_matches_jax():
    x, y = _sine(2000, 8.0)
    _close(px.peaks_parabola(y, x, device="cpu"), jpx.peaks_parabola(y, x), 1e-9)


@pytest.mark.parametrize("points", [31, 40])
def test_fit_quadratic_matches_jax(points):
    x, y = _sine(2000, 8.0, noise=0.01)
    idx = np.asarray([int(p[0]) for p in jpx.peaks_zero_crossing(y)[0]])
    xw, yw = px._peak_windows(y, x, idx, points + 1 - points % 2)
    got = px._fit_quadratic(torch.from_numpy(xw), torch.from_numpy(yw))
    want = jpx._fit_quadratic(jnp.asarray(xw), jnp.asarray(yw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-9)


@pytest.mark.parametrize("locked", [False, True])
def test_peaks_sine_matches_jax(locked):
    x, y = _sine(3000, 6.0, offset=0.35, noise=0.01)
    if locked:
        ours, theirs = px.peaks_sine_locked(y, x, device="cpu"), jpx.peaks_sine_locked(y, x)
    else:
        ours, theirs = px.peaks_sine(y, x, device="cpu"), jpx.peaks_sine(y, x)
    _close(ours, theirs, 1e-9)


@pytest.mark.parametrize("locked", [False, True])
def test_peaks_sine_ground_truth(locked):
    """The JAX file's analytic check: interior peak positions within 2e-3,
    amplitudes within 5e-3 of 1 +/- the offset."""
    periods, offset = 6.0, 0.35
    x, y = _sine(3000, periods, offset=offset)
    fn = px.peaks_sine_locked if locked else px.peaks_sine
    max_p, min_p = fn(y, x, 31, device="cpu")
    true_max = (np.arange(periods) + 0.25) / periods
    true_min = (np.arange(periods) + 0.75) / periods
    got_max = np.sort([p[0] for p in max_p])
    got_min = np.sort([p[0] for p in min_p])
    for t in true_max[1:-1]:
        assert np.min(np.abs(got_max - t)) < 2e-3
    for t in true_min[1:-1]:
        assert np.min(np.abs(got_min - t)) < 2e-3
    np.testing.assert_allclose([p[1] for p in max_p], 1.0 + offset, atol=5e-3)
    np.testing.assert_allclose([p[1] for p in min_p], -1.0 + offset, atol=5e-3)


@pytest.mark.parametrize("n", [2, 257, 3000])
def test_cspline_coeffs_match_jax_and_scipy(n):
    y = np.random.default_rng(n).standard_normal(n)
    got = px._cspline_coeffs(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, cspline1d(y), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(jpx._cspline_coeffs(jnp.asarray(y))),
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_first_order_scan_is_the_recursion(n):
    u = np.random.default_rng(n).standard_normal(n)
    z = px._SPLINE_POLE
    want = u.copy()
    for i in range(1, n):
        want[i] = u[i] + z * want[i - 1]
    got = px._first_order_scan(torch.from_numpy(u), z).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_cspline_eval_matches_jax():
    y = np.random.default_rng(4).standard_normal(300)
    c = px._cspline_coeffs(torch.from_numpy(y))
    u = np.linspace(0.0, 299.0, 300 * 21)
    got = px._cspline_eval(c, torch.from_numpy(u)).numpy()
    want = np.asarray(jpx._cspline_eval(jnp.asarray(c.numpy()), jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # the spline interpolates: at the interior knots it returns the samples
    knots = px._cspline_eval(c, torch.arange(300, dtype=torch.float64)).numpy()
    np.testing.assert_allclose(knots[1:-1], y[1:-1], rtol=0, atol=1e-9)


@pytest.mark.parametrize("n,periods", [(1000, 4.0), (2000, 8.0)])
def test_peaks_spline_matches_jax(n, periods):
    x, y = _sine(n, periods)
    _close(px.peaks_spline(y, x, device="cpu"), jpx.peaks_spline(y, x), 1e-8)


def _raises(fn, *args, **kw):
    with pytest.raises(ValueError) as e:
        fn(*args, **kw)
    return str(e.value)


@pytest.mark.parametrize("case", ["short", "window", "ndim", "no_crossing"])
def test_smoothing_errors_match_jax(case):
    y = np.sin(np.linspace(0, 20, 200))
    args = {"short": (y[:5], 11, "hanning"), "window": (y, 11, "kaiser"),
            "ndim": (y.reshape(2, 100), 11, "hanning")}
    if case == "no_crossing":
        assert _raises(px.zero_crossings, y + 3.0) == _raises(jpx.zero_crossings, y + 3.0)
        return
    assert _raises(px.smooth, *args[case]) == _raises(jpx.smooth, *args[case])


@pytest.mark.parametrize("name", ["peaks_zero_crossing", "peaks_parabola", "peaks_sine",
                                  "peaks_sine_locked", "peaks_spline"])
def test_mismatched_axes_raise_as_jax(name):
    x, y = _sine(1000, 4.0)
    kw = {} if name == "peaks_zero_crossing" else {"device": "cpu"}
    assert (_raises(getattr(px, name), y, x[:-1], **kw)
            == _raises(getattr(jpx, name), y, x[:-1]))


@pytest.mark.parametrize("name", ["peaks_fft", "peaks_parabola", "peaks_sine",
                                  "peaks_sine_locked", "peaks_spline"])
def test_device_none_needs_a_card(name):
    """The device rule: None is the current CUDA device and raises without
    one (the CPU is asked for, never fallen back to)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x, y = _sine(1000, 4.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(px, name)(y, x)
