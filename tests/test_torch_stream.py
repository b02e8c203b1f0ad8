"""K4 (`ops.ddc.ddc_fm_c64`), the complex-block front end, the stream API
(`stream/`), the FM decoder and the filter facade of the port against the
JAX package, on the same numpy inputs.

Stated tolerances:
- fp32 against fp32 (K4's plain version against the JAX Pallas K4 in
  interpret mode, fp32 port paths against their JAX counterparts): wrapped
  phase differences, 99.9th percentile < 1e-4 rad and max < 2e-2 rad, the
  JAX suite's bars (tests/test_pallas.py:84-87): the discriminator amplifies
  rounding where |c| is tiny;
- fp32 against the fp64 oracle: < 2e-4 rad (tests/test_pallas.py:33);
  the carried c_last within 5e-6 of the largest |c| (tests/test_ddc_conv.py:49);
- complex128 paths: 1e-9 (tests/test_api.py:29-44, which holds the generic
  chain to the fused one in complex128 only);
- host NumPy copies (design): exactly equal.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu import constants as JK
from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.models.fm import FmDecoder as JFmDecoder
from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.models.frontend import DdcFmStream as JDdcFmStream
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu.ops import filters as jfilters
from directdemod_tpu.ops.pallas_ddc import TILE, ddc_fm_pallas
from directdemod_tpu.stream import pipeline as jpl
from directdemod_tpu.stream.api import Stream as JStream
from directdemod_tpu_torch import constants as K
from directdemod_tpu_torch.io.sources import ArraySource
from directdemod_tpu_torch.models.fm import FmDecoder
from directdemod_tpu_torch.models.frontend import DdcFm, DdcFmStream
from directdemod_tpu_torch.ops import ddc, design, filters, fir
from directdemod_tpu_torch.stream import checkpoint, pipeline as pl
from directdemod_tpu_torch.stream.api import Stream

torch.set_num_threads(1)

FS = 2048000


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)))))


def _assert_phase_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = _wrapped(got, ref)
    assert np.percentile(d, 99.9) < 1e-4, np.percentile(d, 99.9)
    assert d.max() < 2e-2, d.max()


@pytest.fixture(scope="module")
def capture():
    """An FM capture at a 30 kHz offset with noise (complex64)."""
    rng = np.random.default_rng(21)
    n = 400_000
    t = np.arange(n) / FS
    x = (90 * np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 700 * t)))
         + 2 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex64)


def _k4_consts(bw=60000):
    fe = JDdcFm(FS, 30000, jdesign.blackmanharris(151), bw, fm=True)
    return fe, np.asarray(fe.taps_mod[::-1], np.complex64), np.complex64(fe.rot)


def _oracle(x, w, j, out_len, cp, rot):
    """fp64 windows and discriminator."""
    k = len(w)
    c = np.asarray([np.dot(np.asarray(w, np.complex128), x[m * j:m * j + k])
                    for m in range(out_len)])
    prev = np.concatenate([np.asarray(cp, np.complex128), c[:-1]])
    return np.angle(c * np.conj(prev) * complex(rot)), c


def _port_k4(x, w, rot, cp, j, out_len):
    audio, c_last = ddc.ddc_fm_c64(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.tensor([rot]), torch.from_numpy(cp),
                                   j, out_len)
    return audio.numpy(), c_last.numpy()


# ----------------------------------------------------------------- K4

def test_k4_plain_matches_pallas_interpret_and_oracle(rng):
    """At out_len = 4 tiles of the TPU kernel (a multiple of its 512-output
    tile, where its carry is c[out_len-1] too)."""
    fe, w, rot = _k4_consts()
    j, k = fe.stride, len(fe.taps)
    out_len = 4 * TILE
    x = (rng.standard_normal(out_len * j + k)
         + 1j * rng.standard_normal(out_len * j + k)).astype(np.complex64)
    cp = np.asarray([1.0 + 0.5j], np.complex64)
    a_port, c_port = _port_k4(x, w, rot, cp, j, out_len)
    a_jax, c_jax = ddc_fm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(rot),
                                 jnp.asarray(cp), j, out_len, True)
    assert a_port.shape == (out_len,) and a_port.dtype == np.float32
    _assert_phase_close(a_port, np.asarray(a_jax))
    ref, c = _oracle(x.astype(np.complex128), w, j, out_len, cp, rot)
    assert _wrapped(a_port, ref).max() < 2e-4
    scale = np.max(np.abs(c))
    assert abs(complex(c_port[0]) - c[-1]) / scale < 5e-6
    assert abs(complex(c_port[0]) - complex(np.asarray(c_jax)[0])) / scale < 5e-6


@pytest.mark.parametrize("out_len", [1, 700, 1031])
def test_k4_plain_ragged_matches_oracle(rng, out_len):
    fe, w, rot = _k4_consts()
    j, k = fe.stride, len(fe.taps)
    n = (out_len - 1) * j + k + 5
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    cp = np.asarray([-2.0 + 1.0j], np.complex64)
    a_port, c_port = _port_k4(x, w, rot, cp, j, out_len)
    ref, c = _oracle(x.astype(np.complex128), w, j, out_len, cp, rot)
    assert a_port.shape == (out_len,)
    assert _wrapped(a_port, ref).max() < 2e-4
    assert abs(complex(c_port[0]) - c[-1]) / np.max(np.abs(c)) < 5e-6


def test_jax_k4_c_last_is_not_the_last_output(rng):
    """A fault of the reference the port does not copy: at an out_len that
    is not a multiple of 512 the JAX K4 returns the carry at the end of its
    tile grid, where the window reads zero padding, not c[out_len-1]; the
    port returns c[out_len-1]."""
    fe, w, rot = _k4_consts()
    j, k = fe.stride, len(fe.taps)
    out_len = 700
    n = (out_len - 1) * j + k
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    cp = np.asarray([1.0 + 0j], np.complex64)
    _, c_jax = ddc_fm_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(rot),
                             jnp.asarray(cp), j, out_len, True)
    _, c_port = _port_k4(x, w, rot, cp, j, out_len)
    _, c = _oracle(x.astype(np.complex128), w, j, out_len, cp, rot)
    scale = np.max(np.abs(c))
    assert abs(complex(np.asarray(c_jax)[0]) - c[-1]) / scale > 1e-2
    assert abs(complex(c_port[0]) - c[-1]) / scale < 5e-6


def test_k4_channel_axis_matches_single_channels(rng):
    """(C, K) taps: each channel as its own single-channel call."""
    j, k, out_len = 34, 151, 333
    n = (out_len - 1) * j + k
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                         .astype(np.complex64))
    fes = [JDdcFm(FS, f, jdesign.blackmanharris(151), 60000)
           for f in (30000, -120000, 412500)]
    w = torch.from_numpy(np.stack([fe.taps_mod[::-1] for fe in fes]).astype(np.complex64))
    rot = torch.tensor([complex(fe.rot) for fe in fes], dtype=torch.complex64)
    cp = torch.tensor([1 + 1j, -1j, 0.5], dtype=torch.complex64)
    audio, c_last = ddc.ddc_fm_c64(x, w, rot, cp, j, out_len)
    assert audio.shape == (3, out_len) and c_last.shape == (3,)
    for ch in range(3):
        a1, c1 = ddc.ddc_fm_c64(x, w[ch].contiguous(), rot[ch:ch + 1],
                                cp[ch:ch + 1], j, out_len)
        _assert_phase_close(audio[ch].numpy(), a1.numpy())
        assert abs(complex(c_last[ch] - c1[0])) < 1e-5 * abs(complex(c1[0]))


def test_k4_plain_at_a_large_stride(rng):
    """J = 409 (a 5 kHz `-b`), where a kernel must stage in fewer outputs a
    block: the plain version against the fp64 oracle, and the stream on
    complex blocks against the JAX DdcFmStream(backend="xla")."""
    fe = JDdcFm(FS, 30000, jdesign.blackmanharris(151), 5000, fm=True)
    w, rot = np.asarray(fe.taps_mod[::-1], np.complex64), np.complex64(fe.rot)
    j, k = fe.stride, len(fe.taps)
    assert j == 409
    out_len = 300
    n = (out_len - 1) * j + k
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    cp = np.asarray([1.0 + 0j], np.complex64)
    a_port, _ = _port_k4(x, w, rot, cp, j, out_len)
    ref, _ = _oracle(x.astype(np.complex128), w, j, out_len, cp, rot)
    assert _wrapped(a_port, ref).max() < 2e-4
    port = DdcFm(FS, 30000, design.blackmanharris(151), 5000)
    got, _ = port.process(ArraySource(x, FS), block_size=40_000, device="cpu")
    want, _ = fe.process(JArraySource(x, FS), block_size=40_000, backend="xla")
    _assert_phase_close(got, want)


def test_k4_wrapper_counts_no_launch_on_the_cpu_and_checks(rng):
    j, k = 34, 151
    x = torch.zeros(9 * j + k, dtype=torch.complex64)
    w = torch.ones(k, dtype=torch.complex64)
    one = torch.ones(1, dtype=torch.complex64)
    before = ddc.LAUNCHES_C64
    a, c = ddc.ddc_fm_c64(x, w, one, one, j, 10)
    a_p, c_p = ddc.ddc_fm_c64_plain(x, w, one, one, j, 10)
    assert ddc.LAUNCHES_C64 == before
    assert torch.equal(a, a_p) and torch.equal(c, c_p)
    for bad in (dict(x=x.to(torch.complex128)), dict(x=x[:-1]),
                dict(w=w.to(torch.complex128)), dict(rot=torch.ones(2, dtype=torch.complex64)),
                dict(out_len=0), dict(stride=0), dict(x=torch.zeros(2 * x.shape[0],
                                                                    dtype=torch.complex64)[::2])):
        args = dict(x=x, w=w, rot=one, cp=one, stride=j, out_len=10) | bad
        with pytest.raises(ValueError):
            ddc.ddc_fm_c64(args["x"], args["w"], args["rot"], args["cp"],
                           args["stride"], args["out_len"])


@pytest.mark.parametrize("kind", ["u8", "c64"])
def test_head_is_read_before_the_block(rng, kind):
    """The wrappers' `head`: windows over [head | x] equal those over the
    concatenated samples bit for bit, and the head counts towards the
    samples the windows need; a head of another dtype, or one that splits
    an (I, Q) pair, raises."""
    fe, w, rot = _k4_consts()
    j, k, out_len = fe.stride, len(fe.taps), 300
    n = (out_len - 1) * j + k
    w, rot, cp = (torch.from_numpy(w), torch.tensor([rot]),
                  torch.tensor([1 + 0.5j], dtype=torch.complex64))
    if kind == "u8":
        x, fn, cut = torch.from_numpy(rng.integers(0, 256, 2 * n).astype(np.uint8)), \
            ddc.ddc_fm_u8, 2 * 150
        bad = (x[:cut].to(torch.int16), x[:cut - 1])
    else:
        x, fn, cut = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                                      .astype(np.complex64)), ddc.ddc_fm_c64, 150
        bad = (x[:cut].to(torch.complex128),)
    whole = fn(x, w, rot, cp, j, out_len)
    split = fn(x[cut:], w, rot, cp, j, out_len, head=x[:cut])
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[1], split[1])
    for head in bad:
        with pytest.raises(ValueError):
            fn(x[cut:], w, rot, cp, j, out_len, head=head)
    with pytest.raises(ValueError):                      # one sample short
        fn(x[cut:-(2 if kind == "u8" else 1)], w, rot, cp, j, out_len, head=x[:cut])


# ----------------------------------------------------------- front end

@pytest.mark.parametrize("fm,dtype", [(True, "complex64"), (False, "complex64"),
                                      (True, "complex128"), (False, "complex128")])
def test_stream_on_complex_blocks_matches_jax(capture, fm, dtype):
    """Complex blocks, block 0 included: K4 (plain version) for fm and
    complex64, `fir_decimate` for the complex stream and for complex128."""
    x = capture[:300_001]
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000, fm=fm)
    jfe = JDdcFm(FS, 30000, jdesign.blackmanharris(151), 60000, fm=fm)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    stream = DdcFmStream(fe, "cpu", tdt)
    jstream = JDdcFmStream(jfe, dtype=jdt)
    for s in range(0, len(x), 70_000):
        blk = x[s:s + 70_000].astype(dtype)
        got = stream.step(torch.from_numpy(blk), s).numpy()
        want = np.asarray(jstream.step(jnp.asarray(blk), s))
        assert got.shape == want.shape and got.dtype == want.dtype
        if dtype == "complex128":
            assert np.max(np.abs(got - want)) < 1e-9
        elif fm:
            _assert_phase_close(got, want)
        else:
            assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


def test_stream_complex_block0_runs_the_kernel_path(capture):
    """Block 0 of a one-channel complex stream: K4 (its plain version on the
    CPU) over [hist0 | block], the JAX block 0 within the fp32 bars."""
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000)
    jfe = JDdcFm(FS, 30000, jdesign.blackmanharris(151), 60000, fm=True)
    got, _ = fe.process(ArraySource(capture, FS), device="cpu")
    want, _ = jfe.process(JArraySource(capture, FS))
    _assert_phase_close(got, want)


# ----------------------------------------------------------- stream API

def _t3(S, f, src, **kw):
    return (S(src, **kw).shift(30000).filter(f.blackman_harris(151))
            .bw_limit(60000).fm_demod())


def _t2(S, f, src, **kw):
    return _t3(S, f, src, **kw).filter(f.butter(60235, 400, 4400, kind=2))


@pytest.mark.parametrize("chain,how", [("t3", "run"), ("t3", "run_fused"),
                                       ("t2", "run"), ("t2", "run_fused")])
def test_tutorial_chains_match_jax(capture, chain, how):
    """Tutorial 3's chain (shift, FIR, bw_limit, fm_demod) through the
    generic pipeline and the fused front end, tutorial 2's (with a
    400-4400 Hz Butterworth band-pass after the discriminator, which no
    fused path takes), each against the same JAX path."""
    mk = _t3 if chain == "t3" else _t2
    got, rate = getattr(mk(Stream, filters, ArraySource(capture, FS),
                           device="cpu"), how)(block_size=150_000)
    want, jrate = getattr(mk(JStream, jfilters, JArraySource(capture, FS)),
                          how)(block_size=150_000)
    assert rate == jrate == 60235
    _assert_phase_close(got, want)


def test_run_and_run_fused_agree_in_complex128(capture):
    """The port's own generic chain against its fused one (complex128,
    the bar of tests/test_api.py:29-44)."""
    x = capture.astype(np.complex128)
    chain = _t3(Stream, filters, ArraySource(x, FS), dtype=torch.complex128,
                device="cpu")
    a, r1 = chain.run(block_size=150_000)
    b, r2 = chain.run_fused(block_size=150_000)
    assert r1 == r2 == 60235 and a.dtype == np.float64
    assert np.max(np.abs(a - b)) < 1e-9


def test_strict_resample_zero_phase_and_apply(capture):
    """bw_limit(strict=True), zero-phase FIR and Butterworth, apply."""
    src, jsrc = ArraySource(capture[:200_000], FS), JArraySource(capture[:200_000], FS)

    def chain(S, f, s, absf, **kw):
        return (S(s, **kw).shift(30000).filter(f.blackman_harris(151))
                .bw_limit(60000).fm_demod()
                .filter(f.hamming(31), zero_phase=True)
                .filter(f.butter(60235, 300, 3000, kind=2), zero_phase=True)
                .bw_limit(20800, strict=True).apply(absf))
    got, rate = chain(Stream, filters, src, torch.abs, device="cpu").run(block_size=70_000)
    want, jrate = chain(JStream, jfilters, jsrc, jnp.abs).run(block_size=70_000)
    assert rate == jrate == 20800 and got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-4 * np.max(np.abs(want))


def _pipe(ops_mod, **kw):
    f = filters if ops_mod is pl else jfilters
    return ops_mod.Pipeline([ops_mod.Shift(30000), ops_mod.Filter(f.blackman_harris(151)),
                             ops_mod.BwLim(60000), ops_mod.FmDemod(),
                             ops_mod.Butter(f.butter(60235, 400, 4400, kind=2))],
                            FS, **kw)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(capture, tmp_path, writer):
    """A checkpoint written after block 3 by one package (same chain, same
    file layout) resumes in a fresh pipeline of the other; the resumed
    output equals the all-JAX run within the fp32 bars (on plain
    differences: the Butterworth after the discriminator smooths the
    phase outputs)."""
    ck = str(tmp_path / "pipe.ckpt")
    blk = 60_000
    head = capture[:3 * blk]
    jfull, _ = _pipe(jpl).process(JArraySource(capture, FS), block_size=blk)
    if writer == "jax":
        first, _ = _pipe(jpl).process(JArraySource(head, FS), block_size=blk,
                                      checkpoint_path=ck)
        rest, _ = _pipe(pl, device="cpu").process(
            ArraySource(capture, FS), block_size=blk, checkpoint_path=ck,
            resume=True)
    else:
        first, _ = _pipe(pl, device="cpu").process(
            ArraySource(head, FS), block_size=blk, checkpoint_path=ck)
        rest, _ = _pipe(jpl).process(JArraySource(capture, FS), block_size=blk,
                                     checkpoint_path=ck, resume=True)
    resumed = np.concatenate([first, np.asarray(rest)])
    assert resumed.shape == jfull.shape
    d = np.abs(resumed - jfull)
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2
    state, position, meta = checkpoint.restore(
        ck, _pipe(pl, device="cpu").init_states())
    assert position == len(capture) and meta == {}
    assert [None if t is None else t.dtype for t in state] == \
        [None, torch.complex64, None, torch.complex64, torch.float32]


def test_checkpoint_resume_is_bit_exact(capture, tmp_path):
    ck = str(tmp_path / "p.ckpt")
    blk = 60_000
    full, _ = _pipe(pl, device="cpu").process(ArraySource(capture, FS), block_size=blk)
    first, _ = _pipe(pl, device="cpu").process(ArraySource(capture[:3 * blk], FS),
                                               block_size=blk, checkpoint_path=ck)
    rest, _ = _pipe(pl, device="cpu").process(ArraySource(capture, FS), block_size=blk,
                                              checkpoint_path=ck, resume=True)
    assert np.array_equal(np.concatenate([first, rest]), full)
    with pytest.raises(ValueError):
        checkpoint.restore(ck, [None, torch.zeros(1)])


# ----------------------------------------------------------- FM decoder

def test_fm_decoder_tone():
    """The tone test of tests/test_api.py:136-154 on the port, and its
    audio against the JAX decoder's."""
    fs, tone, dev = 2048000, 1200.0, 9000.0
    t = np.arange(fs) / fs
    ph = 2 * np.pi * 30000 * t + (dev / tone) * np.sin(2 * np.pi * tone * t)
    iq = (90 * np.exp(1j * ph)).astype(np.complex64)
    dec = FmDecoder(ArraySource(iq, fs), offset=30000, bw=60000, audio_freq=15000,
                    device="cpu")
    audio, rate = dec.get_audio()
    assert rate > 0 and len(audio) > rate // 2
    spec = np.abs(np.fft.rfft(audio[rate // 4:]))
    peak = (np.argmax(spec[5:]) + 5) * rate / (len(audio) - rate // 4)
    assert abs(peak - tone) < 30, peak
    want, jrate = JFmDecoder(JArraySource(iq, fs), offset=30000, bw=60000,
                             audio_freq=15000).get_audio()
    assert jrate == rate and audio.shape == want.shape
    assert np.max(np.abs(audio - want)) < 1e-4
    assert set(dec.stage_seconds) == {"fm_frontend", "resample"}


@pytest.mark.parametrize("strict", [True, False])
def test_fm_decoder_matches_jax_across_blocks(capture, monkeypatch, strict):
    from directdemod_tpu_torch import constants as pconst
    monkeypatch.setattr(pconst, "PROC_CHUNKSIZE", 150_000)
    monkeypatch.setattr(JK, "PROC_CHUNKSIZE", 150_000)
    import directdemod_tpu.models.fm as jfm
    monkeypatch.setattr(jfm, "PROC_CHUNKSIZE", 150_000)
    got, rate = FmDecoder(ArraySource(capture, FS), 30000, strict=strict,
                          device="cpu").get_audio()
    want, jrate = JFmDecoder(JArraySource(capture, FS), 30000,
                             strict=strict).get_audio()
    assert rate == jrate and got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-4


def test_fm_decoder_recovers_the_modulating_audio(monkeypatch):
    """The FM capture of chip_smoke.py's phase 15 (its synthesizer, at 2 s
    in 400,000-sample blocks): the port's audio and the JAX decoder's both
    correlate with the modulating audio at >= 0.99 (the per-block Fourier
    resample rings at block edges in both), the port's no lower than the
    JAX package's."""
    import chip_smoke
    from directdemod_tpu_torch import constants as pconst
    import directdemod_tpu.models.fm as jfm
    blk = 400_000
    monkeypatch.setattr(pconst, "PROC_CHUNKSIZE", blk)
    monkeypatch.setattr(jfm, "PROC_CHUNKSIZE", blk)
    n = 2 * FS
    x = chip_smoke.synth_fm(n, "cpu", seed=5)
    got, rate = FmDecoder(ArraySource(x, FS), 30000, bw=30000, audio_freq=15000,
                          device="cpu").get_audio()
    want, jrate = JFmDecoder(JArraySource(x, FS), 30000, bw=30000,
                             audio_freq=15000).get_audio()
    times = chip_smoke.fm_audio_times(n, 68, FS // 68, rate, blk)
    corr, _ = chip_smoke.fm_correlation(got, times, "cpu")
    jcorr, _ = chip_smoke.fm_correlation(np.asarray(want), times, "cpu")
    assert rate == jrate == 15000
    assert jcorr >= 0.99 and corr >= 0.99 and corr >= jcorr - 1e-6, (corr, jcorr)


# ----------------------------------------------------------- design / filters

def test_design_window_copies_are_exact():
    assert np.array_equal(design.gaussian(51, 7.5), jdesign.gaussian(51, 7.5))
    assert np.array_equal(design.rolling_average(9), jdesign.rolling_average(9))
    assert np.array_equal(filters.gaussian(31, 4.0), jfilters.gaussian(31, 4.0))
    assert np.array_equal(filters.rolling_average(), jfilters.rolling_average())
    assert np.array_equal(filters.hamming(33), jfilters.hamming(33))
    assert np.array_equal(fir.ones_history(151, torch.complex64).numpy(),
                          np.ones(150, np.complex64))


@pytest.mark.parametrize("spec", [
    (43, [0, 100, 400, 500, 600, 700], [0, 1, 0.5], 2000),
    (128, [0, 0.18, 0.22, 0.5], [1, 0], 1.0),
    (73, [0, 0.1, 0.15, 0.35, 0.4, 0.5], [1, 0.5, 1], 1.0),
    (129, [0, 100, 400, 500, 600, 700], [0, 1, 0.5], 2000),   # the fallback
])
def test_remez_copy_is_exact(spec):
    n, bands, desired, fs = spec
    assert np.array_equal(design.remez(n, bands, desired, fs=fs),
                          jdesign.remez(n, bands, desired, fs=fs))


def test_filters_facade_matches_jax(rng):
    bands = [[0, 100], [400, 500], [600, 700]]
    assert np.array_equal(filters.remez(2000, bands, [0, 1, 0.5], ntaps=43),
                          jfilters.remez(2000, bands, [0, 1, 0.5], ntaps=43))
    for bad in (([], []), ([[0, 1000]], [1]), ([[0, 100]], [1, 0])):
        with pytest.raises(ValueError):
            filters.remez(2000, *bad)
    bf, jbf = filters.butter(60235, 400, 4400, kind=K.FLT_BP), \
        jfilters.butter(60235, 400, 4400, kind=JK.FLT_BP)
    assert np.array_equal(bf.sos, np.asarray(jbf.sos))
    with pytest.raises(ValueError):
        filters.butter(60235, 400, kind=K.FLT_BS)
    x = rng.standard_normal(1001)
    taps = design.blackmanharris(31)
    assert np.allclose(filters.convolve_same(torch.from_numpy(x), taps).numpy(),
                       np.asarray(jfilters.convolve_same(x, taps)), atol=1e-12)
    for n in (5, 4):
        assert np.allclose(filters.median_filter(torch.from_numpy(x), n).numpy(),
                           np.asarray(jfilters.median_filter(x, n)), atol=0)
