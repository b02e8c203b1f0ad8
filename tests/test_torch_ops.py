"""The port's ops modules against the JAX package on the same numpy inputs.

Both sides compute in float32 / complex64 (the JAX suite runs with x64 on,
so dtypes are passed explicitly). Tolerances are relative to the output's
scale and sized for float32 sums of the lengths involved; the host-side
NumPy copies (`design`, the peak grouping) must agree exactly."""
import inspect
import logging

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu import constants as jconstants
from directdemod_tpu.ops import am as jam
from directdemod_tpu.ops import correlate as jcorr
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu.ops import fir as jfir
from directdemod_tpu.ops import fm as jfm
from directdemod_tpu.ops import iir as jiir
from directdemod_tpu.ops import peaks as jpeaks
from directdemod_tpu.ops import resample as jrs
from directdemod_tpu.ops import unpack as junpack
from directdemod_tpu.utils import logsetup as jlogsetup
from directdemod_tpu_torch import constants
from directdemod_tpu_torch.models import stages
from directdemod_tpu_torch.models.apt import median
from directdemod_tpu_torch.ops import am, correlate, design, fir, fm, iir, peaks
from directdemod_tpu_torch.ops import resample as rs
from directdemod_tpu_torch.ops import unpack
from directdemod_tpu_torch.utils import logsetup

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-30)
    err = np.max(np.abs(got - ref)) / scale
    assert err < rtol, err


def test_constants_equal_the_reference():
    names = [n for n in dir(constants) if n.isupper()]
    assert len(names) == 32                 # the source kinds among them
    for name in names:
        assert getattr(constants, name) == getattr(jconstants, name), name


def test_logsetup_copy_equals_the_reference(tmp_path):
    """The same root handlers, levels and format; the code differs only in
    its docstring and in naming torch among the noisy loggers."""
    body = [inspect.getsource(m.setup).replace('"jax", "jax._src"', '"torch"')
            for m in (logsetup, jlogsetup)]
    assert body[0] == body[1]
    root = logging.getLogger()
    before, level = list(root.handlers), root.level
    got = []
    for m in (logsetup, jlogsetup):
        m.setup(str(tmp_path / "log.txt"), console=True)
        added = [h for h in root.handlers if h not in before]
        got.append([(type(h).__name__, h.level, h.formatter._fmt) for h in added]
                   + [root.level])
        for h in added:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)
    assert got[0] == got[1]
    assert got[0][0] == ("FileHandler", logging.DEBUG,
                         "%(asctime)s - %(name)s - %(levelname)s - %(message)s")


def test_design_copies_are_exact():
    assert np.array_equal(design.blackmanharris(151), jdesign.blackmanharris(151))
    assert np.array_equal(design.hamming(492), jdesign.hamming(492))
    for order, wn, kind in ((6, [400 / 30117.5, 4400 / 30117.5], "bandpass"),
                            (4, 0.2, "lowpass"), (3, 0.3, "highpass"),
                            (2, [0.2, 0.4], "bandstop")):
        assert np.array_equal(design.butter_sos(order, wn, kind),
                              jdesign.butter_sos(order, wn, kind))
    b, a = [0.2, 0.3, 0.1], [1.0, -0.5, 0.25]
    assert np.array_equal(design.lfilter_zi(b, a), jdesign.lfilter_zi(b, a))


def test_unpack_and_decimation_bookkeeping(rng):
    raw = rng.integers(0, 256, 2 * 5000).astype(np.uint8)
    assert np.array_equal(unpack.iq_u8_to_complex(_t(raw)).numpy(),
                          np.asarray(junpack.iq_u8_to_complex(jnp.asarray(raw))))
    for fs, target in ((2048000, 60000), (2048000, 20800), (1000000, 7000)):
        assert rs.decim_params(fs, target) == jrs.decim_params(fs, target)
    for start in (0, 1, 33, 20_000_000, 2**40 + 5):
        off = rs.decim_phase(start, 34)
        assert off == jrs.decim_phase(start, 34)
        assert rs.decim_count(1000, off, 34) == jrs.decim_count(1000, off, 34)
    x = rng.standard_normal(1000).astype(np.float32)
    assert np.array_equal(rs.decimate(_t(x), 5, 7, 100).numpy(),
                          np.asarray(jrs.decimate(jnp.asarray(x), 5, 7, 100)))


@pytest.mark.parametrize("n,block", [(5500, 1000), (4000, 1000), (999, 1000),
                                     (7001, 2000)])
def test_envelope_blocked(rng, n, block):
    x = rng.standard_normal(n).astype(np.float32)
    got = am.envelope_blocked(_t(x), block).numpy()
    ref = jam.envelope_blocked(jnp.asarray(x), block)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64])
def test_envelope_lowpass(rng, dtype):
    """The low-pass AM demod against JAX, and chunked with the carried state
    equal to one call (up to the association of the block sums)."""
    n = 30_000
    x = rng.standard_normal(n)
    if dtype == np.complex64:
        x = x + 1j * rng.standard_normal(n)
    x = x.astype(dtype)
    got, st = am.envelope_lowpass(_t(x), 48000, 3000)
    want, jst = jam.envelope_lowpass(jnp.asarray(x), 48000, 3000)
    real = np.float64 if dtype == np.float64 else np.float32
    assert got.numpy().dtype == real and st.numpy().dtype == real
    tol = 1e-12 if dtype == np.float64 else 1e-5
    _close(got, np.asarray(want), tol)
    _close(st, np.asarray(jst), tol)
    a, s1 = am.envelope_lowpass(_t(x[:12_345]), 48000, 3000)
    b, s2 = am.envelope_lowpass(_t(x[12_345:]), 48000, 3000, s1)
    _close(torch.cat([a, b]), got.numpy(), tol)
    _close(s2, st.numpy(), tol)


def test_norm_correlate_and_correlate_same(rng):
    x = np.abs(rng.standard_normal(3000)).astype(np.float32)
    needle = jcorr.apt_needle((0, 1, 1, 0, 1), 1000, 0.004, True)
    assert np.array_equal(correlate.apt_needle((0, 1, 1, 0, 1), 1000, 0.004,
                                               True), needle)
    nd = needle.astype(np.float32)
    _close(correlate.norm_correlate(_t(x), _t(nd)).numpy(),
           jcorr.norm_correlate(jnp.asarray(x), jnp.asarray(nd)), 1e-5)
    signed = (needle - 0.5).astype(np.float32)
    _close(correlate.correlate_same(_t(x), _t(signed)).numpy(),
           jcorr.correlate_same(jnp.asarray(x), jnp.asarray(signed)), 1e-5)


@pytest.mark.parametrize("n", [9000, 20000])
def test_norm_correlate_multi_blocked(rng, n):
    """The overlap-save framing (n > 2 * blk) and the direct form (n <= 2 *
    blk) against the JAX package with the same frame width."""
    x = np.abs(rng.standard_normal(n)).astype(np.float32)
    na = jcorr.apt_needle((0, 0, 1, 1, 0, 1, 0, 0), 600, 0.05, True)
    nb = jcorr.apt_needle((0, 1, 1, 1, 0, 0, 1, 0), 600, 0.05, True)
    needles = np.stack([na, nb]).astype(np.float32)
    got = correlate.norm_correlate_multi_blocked(_t(x), _t(needles), 4096).numpy()
    ref = jcorr.norm_correlate_multi_blocked(jnp.asarray(x),
                                             jnp.asarray(needles), 4096)
    _close(got, ref, 1e-4)


def test_fft_len_is_five_smooth():
    for n in range(1, 3000):
        m = correlate.fft_len(n)
        assert m >= n
        r = m
        for p in (2, 3, 5):
            while r % p == 0:
                r //= p
        assert r == 1
        assert not any(correlate.fft_len(n) > q >= n and _smooth(q)
                       for q in range(n, m))


def _smooth(q):
    for p in (2, 3, 5):
        while q % p == 0:
            q //= p
    return q == 1


@pytest.mark.parametrize("n,num", [(1000, 800), (1001, 800), (1000, 801),
                                   (1000, 1201), (999, 1200), (1000, 1000),
                                   (15059, 14560)])
@pytest.mark.parametrize("cplx", [False, True])
def test_fft_resample(rng, n, num, cplx):
    x = rng.standard_normal((3, n))
    if cplx:
        x = (x + 1j * rng.standard_normal((3, n))).astype(np.complex64)
    else:
        x = x.astype(np.float32)
    got = rs.fft_resample(_t(x), num).numpy()
    ref = jrs.fft_resample(jnp.asarray(x), num)
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_zero_phase(rng, cplx):
    x = rng.standard_normal((2, 3000))
    if cplx:
        x = (x + 1j * rng.standard_normal((2, 3000))).astype(np.complex64)
    else:
        x = x.astype(np.float32)
    taps = jdesign.hamming(101)
    got = fir.fir_zero_phase(_t(x), taps).numpy()
    ref = np.stack([np.asarray(jfir.fir_zero_phase(jnp.asarray(r), taps))
                    for r in x])
    _close(got, ref, 1e-5)


def test_fir_decimate_complex_taps(rng):
    fe_taps = jdesign.blackmanharris(151) * np.exp(1j * 0.09 * np.arange(151))
    tm = fe_taps.astype(np.complex64)
    x = (rng.standard_normal(20000) + 1j * rng.standard_normal(20000)) \
        .astype(np.complex64)
    hist = (rng.standard_normal(150) + 1j * rng.standard_normal(150)) \
        .astype(np.complex64)
    for off in (0, 5, 33):
        out_len = rs.decim_count(20000, off, 34)
        y, h = fir.fir_decimate(_t(x), _t(tm), _t(hist), off, out_len, 34)
        yr, hr = jfir.fir_decimate(jnp.asarray(x), jnp.asarray(tm),
                                   jnp.asarray(hist), jnp.int32(off), out_len, 34)
        _close(y.numpy(), yr, 1e-5)
        assert np.array_equal(h.numpy(), np.asarray(hr))


def _bandpass_pair():
    jf = jiir.IirFilter.design_butter(60235, 400, 4400, order=6, kind="bandpass")
    return jf, iir.IirFilter(np.asarray(jf.sos))


def test_iir_design_matches():
    jf, pf = _bandpass_pair()
    assert np.array_equal(
        iir.IirFilter.design_butter(60235, 400, 4400, order=6,
                                    kind="bandpass").sos, np.asarray(jf.sos))
    assert np.array_equal(pf.initial_state_step().numpy(),
                          np.asarray(jf.initial_state_step(jnp.float32)))


@pytest.mark.parametrize("n", [50_000, 4096 * 3, 777])
def test_iir_zero_phase(rng, n):
    jf, pf = _bandpass_pair()
    x = rng.standard_normal(n).astype(np.float32)
    got = pf.zero_phase(_t(x)).numpy()
    ref = jf.zero_phase(jnp.asarray(x))
    _close(got, ref, 2e-5)


def test_iir_apply_with_state(rng):
    jf, pf = _bandpass_pair()
    x = rng.standard_normal(30_000).astype(np.float32)
    z = rng.standard_normal(2 * pf.n_sections).astype(np.float32)
    y, zo = pf.apply(_t(x), _t(z))
    yr, zr = jf.apply(jnp.asarray(x), jnp.asarray(z))
    _close(y.numpy(), yr, 2e-5)
    _close(zo.numpy(), zr, 2e-5)


# the decoders' designs: the PSK low-pass (Funcube), the AFSK and NOAA
# band-passes at their audio rates
_IIR_DESIGNS = {
    "psk_lowpass": (2_048_000, constants.FUNCUBE_DEFAULT_BW, None, "lowpass"),
    "afsk_bandpass": (rs.decim_params(2_048_000, constants.AFSK_DEFAULT_BW)[1],
                      constants.AFSK_MARK_HZ - 500, constants.AFSK_SPACE_HZ + 500,
                      "bandpass"),
    "noaa_bandpass": (rs.decim_params(2_048_000, constants.NOAA_FMBW)[1],
                      400, 4400, "bandpass"),
}


def _iir_design(name):
    fs, a, b, kind = _IIR_DESIGNS[name]
    return iir.IirFilter.design_butter(fs, a, b, order=6, kind=kind)


@pytest.mark.parametrize("p", [16, 1792, 2246, 2944, 3328, 4095])
@pytest.mark.parametrize("name", sorted(_IIR_DESIGNS))
def test_iir_tail_constants_are_slices_of_the_block_set(name, p):
    """A p-sample tail's constants are h[:p], S[:p], G[L-p:] of the
    4,096-sample set and A^p its matrix power: the arrays a build for p
    gives, bit for bit."""
    filt = _iir_design(name)
    for s, hSG in zip(filt.sos, iir._host_set(filt.sos, 4096)):
        ss = iir._biquad_state_space(s)
        h, S, G = hSG
        got = iir._slice_constants(hSG, ss[0], p)
        for a, b in zip((h[:p], S[:p], G[4096 - p:]), got):
            assert np.shares_memory(a, b) and np.array_equal(a, b)
        for a, b in zip(got, iir._segment_constants(*ss, p)):
            assert np.array_equal(a, b)


def test_iir_filters_of_one_design_share_a_build(rng):
    """From a cleared cache two filters of one design build one set, and
    the second's lookup is served from it: counted in the session's tally
    while a profiler records, the build one `iir.constants` range."""
    iir.clear_constants()
    x = _t(rng.standard_normal(3 * 4096).astype(np.float32))
    stages.session_counts()      # end a session an earlier test left behind
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            filt = _iir_design("afsk_bandpass")
            filt.apply(x, filt.initial_state_zero())
    assert stages.session_counts() == {"iir.constants.built": 1,
                                       "iir.constants.reused": 1}
    assert [e.count for e in prof.key_averages() if e.key == "iir.constants"] == [1]


def test_iir_segment_loop_runs_once_a_design_and_block(rng, monkeypatch):
    """Every block length and tail of a design comes from its one
    `block`-sample build: blocks with a ragged tail, a short input, a
    complex input and a zero-phase pass run the loop once."""
    iir.clear_constants()
    calls = []
    orig = iir._segment_constants

    def counted(A, B, C, D, L):
        calls.append(L)
        return orig(A, B, C, D, L)
    monkeypatch.setattr(iir, "_segment_constants", counted)
    filt = _iir_design("psk_lowpass")
    for n in (3 * 4096 + 1234, 777, 10):
        filt.apply(_t(rng.standard_normal(n).astype(np.float32)),
                   filt.initial_state_step())
    xc = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64)
    filt.apply(_t(xc), filt.initial_state_step())
    filt.zero_phase(_t(rng.standard_normal(9000).astype(np.float32)))
    assert calls == [4096] * filt.n_sections


def test_iir_constants_cache_is_bounded(rng):
    """A process that filters many lengths keeps at most `_CACHE_SETS`
    device sets, dropping the least recently used first."""
    iir.clear_constants()
    filt = _iir_design("psk_lowpass")
    z = filt.initial_state_zero()
    first = _t(rng.standard_normal(16).astype(np.float32))
    for n in range(16, 16 + iir._CACHE_SETS + 8):
        filt.apply(_t(rng.standard_normal(n).astype(np.float32)), z)
        filt.apply(first, z)                     # kept as the most recent
    assert len(iir._device_sets) == iir._CACHE_SETS
    assert len(iir._host_sets) == 1
    kept = {k[2] for k in iir._device_sets}
    assert 16 in kept and 17 not in kept


def test_iir_threads_share_one_build(rng, monkeypatch):
    """Decoders in threads that filter at once build each design's set
    once and get a single thread's outputs."""
    import sys
    import threading
    iir.clear_constants()
    builds = []
    orig = iir._segment_constants

    def counted(A, B, C, D, L):
        builds.append(L)
        return orig(A, B, C, D, L)
    monkeypatch.setattr(iir, "_segment_constants", counted)
    xs = [_t(rng.standard_normal(n).astype(np.float32)) for n in (5000, 777, 9000)]
    names = sorted(_IIR_DESIGNS)

    def work(k):
        filt = _iir_design(names[k % len(names)])
        return [filt.apply(x, filt.initial_state_step())[0] for x in xs]
    want = [work(k) for k in range(len(names))]
    assert len(builds) == sum(_iir_design(n).n_sections for n in names)
    iir.clear_constants()
    builds.clear()
    got, errors = {}, []

    def run(k):
        try:
            got[k] = work(k)
        except Exception as e:          # reported by the assertion below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(k,)) for k in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(th.is_alive() for th in threads)
    assert len(builds) == sum(_iir_design(n).n_sections for n in names)
    for k in range(12):
        assert all(torch.equal(a, b) for a, b in zip(got[k], want[k % len(names)]))


def _fresh_constants(self, L, p, dtype, device):
    """A build for L and one for p on every call, uncached."""
    out = []
    for s in self.sos:
        ss = iir._biquad_state_space(s)
        h, S, G, AL = (torch.as_tensor(a, dtype=dtype, device=device)
                       for a in iir._segment_constants(*ss, L))
        _, _, Gp, ALp = (torch.as_tensor(a, dtype=dtype, device=device)
                         for a in iir._segment_constants(*ss, p))
        out.append((h, S, G, AL, Gp, ALp))
    return out


@pytest.mark.parametrize("case", ["real", "complex_ragged", "ragged", "short",
                                  "float64", "zero_phase"])
def test_iir_cached_constants_match_a_fresh_build(rng, monkeypatch, case):
    """`apply` and `zero_phase` from a cold cache and a warm one give
    tensors bit for bit those of a fresh, uncached build."""
    filt = _iir_design("noaa_bandpass")
    n = {"real": 3 * 4096, "short": 777, "zero_phase": 20_000}.get(case, 3 * 4096 + 1234)
    x = rng.standard_normal(n)
    z = rng.standard_normal(2 * filt.n_sections)
    if case == "complex_ragged":
        x = x + 1j * rng.standard_normal(n)
        z = z + 1j * rng.standard_normal(2 * filt.n_sections)
    dt = np.float64 if case == "float64" else np.float32
    x, z = _t(x.astype(np.result_type(dt, x.dtype))), \
        _t(z.astype(np.result_type(dt, z.dtype)))

    def run():
        if case == "zero_phase":
            return [filt.zero_phase(x)]
        return list(filt.apply(x, z))
    iir.clear_constants()
    cold, warm = run(), run()
    monkeypatch.setattr(iir.IirFilter, "_constants", _fresh_constants)
    fresh = run()
    for a, b, c in zip(cold, warm, fresh):
        assert a.dtype == c.dtype and a.shape == c.shape
        assert torch.equal(a, c) and torch.equal(b, c)


def test_iir_step_state_is_a_copy():
    """`initial_state_step` hands out its own tensor: writing to one leaves
    the cached state and the next call's as they were."""
    filt = _iir_design("psk_lowpass")
    a = filt.initial_state_step()
    ref = a.clone()
    a.zero_()
    assert torch.equal(filt.initial_state_step(), ref)


def test_quad_demod(rng):
    x = (rng.standard_normal((2, 500)) + 1j * rng.standard_normal((2, 500))) \
        .astype(np.complex64)
    last = np.asarray([1.0 - 2.0j], np.complex64)
    got, _ = fm.quad_demod(_t(x[0]), _t(last))
    ref, _ = jfm.quad_demod(jnp.asarray(x[0]), jnp.asarray(last))
    _close(got.numpy(), ref, 1e-6)
    got, _ = fm.quad_demod(_t(x), None)
    ref = np.stack([np.asarray(jfm.quad_demod(jnp.asarray(r), None)[0])
                    for r in x])
    _close(got.numpy(), ref, 1e-6)


@pytest.mark.parametrize("n,k", [(100_000, 50), (3000, 7), (20_000, 4096)])
def test_top_k_exact(rng, n, k):
    x = rng.standard_normal((2, n)).astype(np.float32)
    got = peaks.top_k_exact(_t(x), k).numpy()
    ref = jpeaks.top_k_exact(jnp.asarray(x), k)
    assert np.array_equal(got, np.asarray(ref))


def test_adaptive_threshold_and_peak_grouping(rng):
    x = rng.standard_normal(60_000).astype(np.float32)
    x[::6000] += 8.0
    thr, k = peaks.adaptive_threshold(_t(x), 6000.0, 0.25)
    thr_j, k_j = jpeaks.adaptive_threshold(jnp.asarray(x), 6000.0, 0.25)
    assert k == k_j
    assert abs(float(thr) - float(thr_j)) < 1e-5 * abs(float(thr_j))
    got = peaks.find_sync_peaks(_t(x), 6000.0, 10, 0.25, 0.45)
    ref = jpeaks.find_sync_peaks(jnp.asarray(x), 6000.0, 10, 0.25, 0.45)
    assert np.array_equal(got, ref)
    assert np.array_equal(peaks.host_find_sync_peaks(x, 6000.0, 10, 0.25, 0.45),
                          jpeaks.host_find_sync_peaks(x, 6000.0, 10, 0.25, 0.45))


@pytest.mark.parametrize("shape", [(7,), (8,), (3, 14), (5, 1040, 14), (2, 1)])
def test_median_mean_of_middles(rng, shape):
    """The median helper equals jnp.median bit for bit, even counts
    included (torch.median would return the lower middle value)."""
    x = rng.standard_normal(shape).astype(np.float32)
    got = median(_t(x)).numpy()
    ref = np.asarray(jnp.median(jnp.asarray(x), axis=-1))
    assert np.array_equal(got, ref)
    assert np.allclose(got, np.median(x, axis=-1), rtol=1e-6)
