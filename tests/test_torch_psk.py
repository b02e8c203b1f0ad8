"""The port's PSK slice (Funcube BPSK, Meteor-M2 QPSK) against the JAX
package on the same numpy inputs: the NCO, the complex low-pass with its
state quirk, the symbol-rate scan (K3's plain version) against the JAX
`symbol_scan`, its segmented form and the JAX Pallas kernel in interpret
mode, the tanh table, the pass-2 replay against the reference-buffer oracle
of tests/test_psk_sync.py, the Doppler track, and the whole decoders.

Stated tolerances:
- symbol indices, minsync flags, needle choices, the tanh table, the NCO
  anchors, the replayed syncs and the decoders' syncs and usefulness:
  equal (the plain scan takes XLA's float32 operations in XLA's order);
- scan phases: 1e-5 rad (XLA's float32 cos/sin are its own polynomial,
  the port's are correctly rounded; the JAX suite holds its two scans to
  the same bar, tests/test_pll_scalar.py);
- NCO mix and the complex low-pass: float32 products and FFT convolutions
  in another order, 2e-5 and 1e-4 of the signal scale;
- Doppler track: within one FFT bin (250 Hz) per row (float32 FFTs of
  another library under the per-row argmax).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu import constants as jK
from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import IQDat as JIQDat
from directdemod_tpu.models import doppler as jdoppler
from directdemod_tpu.models.funcube import FuncubeDecoder as JFuncube
from directdemod_tpu.models.meteorm2 import MeteorM2Decoder as JMeteor
from directdemod_tpu.ops import iir as jiir
from directdemod_tpu.ops import nco as jnco
from directdemod_tpu.ops import pll as jpll
from directdemod_tpu.ops.pll_scalar import bpsk_symbol_scan_packed
from directdemod_tpu_torch import constants as K
from directdemod_tpu_torch.io.sources import ArraySource, DeviceRawSource, IQDat
from directdemod_tpu_torch.models import doppler, psk_sync
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder, _variants
from directdemod_tpu_torch.ops import iir, nco, pll
from tests.test_pll_scalar import _bpsk_stream
from tests.test_psk_sync import (_arming_fixture, _bpsk_capture,
                                 _qpsk_capture, _reference_buffer_oracle)

torch.set_num_threads(1)

FS = 2048000
SYNC12 = np.repeat(np.asarray([int(c) for c in K.FUNCUBE_SYNC_BITS]), 10)
MS, MS1, _ = _variants()
BPSK = dict(fs=FS, sym_rate=12000, qpsk=False, agc_mean0=180.0,
            agc_gain_cap=20.0, costas_bw=0.05235833333 * 6,
            minsync_thresh=120.0)
QPSK = dict(fs=FS, sym_rate=72000, qpsk=True, agc_mean0=3.0,
            agc_gain_cap=200.0, costas_bw=0.008727, minsync_thresh=30.0)


def _jax_scan(kw, x, sync, sync1):
    """The JAX scan's valid symbols: (a_idx, phase, minsync, chosen)."""
    p = jpll.PskParams(**kw)
    _, o = jpll.symbol_scan(p, jnp.asarray(x), jpll.initial_state(p, len(sync)),
                            jnp.asarray(sync, jnp.float32),
                            jnp.asarray(sync1, jnp.float32))
    v = np.asarray(o.valid)
    return tuple(np.asarray(t)[v] for t in (o.a_idx, o.phase_out, o.minsync,
                                            o.chosen))


def _assert_symbols(got: pll.Symbols, want):
    a, ph, m, c = want
    assert got.count == len(a) > 1000
    assert np.array_equal(got.a_idx.numpy(), a)
    assert np.max(np.abs(got.phase_out.numpy() - ph)) < 1e-5
    assert np.array_equal(got.minsync.numpy(), m)
    assert np.array_equal(got.chosen.numpy(), c)


def _qpsk_stream():
    frames = [0.05 + i * 0.11 for i in range(3)]
    return _qpsk_capture(frames, dur_s=0.42)


# ------------------------------------------------------------------- NCO, IIR

def test_nco_matches_jax(rng):
    n, f, start = 50_000, 5123.0, 987_654_321
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    anc = nco.phase_anchors(f, FS, start, n)
    assert np.array_equal(anc, jnco.phase_anchors(f, FS, start, n))
    omega = float(np.float32(-2 * np.pi * f / FS))
    got = nco.mix(torch.from_numpy(x), omega, torch.from_numpy(anc)).numpy()
    want = np.asarray(jnco.mix(jnp.asarray(x), omega, jnp.asarray(anc)))
    assert np.max(np.abs(got - want)) < 2e-5 * np.max(np.abs(x))
    freqs = 5000.0 + 30.0 * np.linspace(0, 1, n)
    got = nco.mix_array_freq(torch.from_numpy(x), freqs, FS, start=7).numpy()
    want = np.asarray(jnco.mix_array_freq(jnp.asarray(x), freqs, FS, start=7))
    assert np.max(np.abs(got - want)) < 2e-5 * np.max(np.abs(x))


def test_complex_lowpass_with_state_quirk_across_blocks(rng):
    """The PSK low-pass: complex input, the real unit-step zi as the state
    (imaginary row from zero), carried across two blocks."""
    n = 30_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64) * 50
    jlp = jiir.IirFilter.design_butter(FS, 7000, order=6, kind="lowpass")
    lp = iir.IirFilter.design_butter(FS, 7000, order=6, kind="lowpass")
    jz = jlp.initial_state_step(jnp.float32).astype(jnp.complex64)
    z = lp.initial_state_step(torch.float32)
    for blk in (x[:12_345], x[12_345:]):
        jy, jz = jlp.apply(jnp.asarray(blk), jz)
        y, z = lp.apply(torch.from_numpy(blk), z)
        assert y.dtype == torch.complex64 and z.is_complex()
        assert np.max(np.abs(y.numpy() - np.asarray(jy))) < 1e-4 * np.max(np.abs(x))
        assert np.max(np.abs(z.numpy() - np.asarray(jz))) < 1e-4 * np.max(np.abs(x))


# ------------------------------------------------------------------- the scan

def test_tanh_table_equals_jax():
    want = np.asarray(jnp.tanh(jnp.arange(-128.0, 128.0, dtype=jnp.float32)))
    assert np.array_equal(np.asarray(pll.TANH_TABLE, np.float32), want)


def test_step_constants_round_once_from_float64():
    p = pll.PskParams(**BPSK)
    jp = jpll.PskParams(**BPSK)
    for locked in (False, True):
        a, b = jpll._alpha_beta(jp, jnp.bool_(locked))
        assert pll.alpha_beta(p, locked) == (float(np.float32(a)), float(np.float32(b)))


@pytest.mark.parametrize("case", ["bpsk_sync", "bpsk_noise", "qpsk"])
def test_plain_scan_matches_jax_symbol_scan(case, rng):
    if case == "bpsk_sync":
        kw, x, s0, s1 = BPSK, _bpsk_stream(300_000), SYNC12, SYNC12
    elif case == "bpsk_noise":
        kw, s0, s1 = BPSK, SYNC12, SYNC12
        n = 300_000
        x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
             .astype(np.complex64) * 30.0)
    else:
        kw, x, s0, s1 = QPSK, _qpsk_stream(), MS, MS1
    p = pll.PskParams(**kw)
    _, got = pll.symbol_scan_plain(p, torch.from_numpy(x),
                                   pll.initial_state(p, len(s0), device="cpu"), s0, s1)
    want = _jax_scan(kw, x, s0, s1)
    _assert_symbols(got, want)
    if case == "bpsk_sync":
        assert got.minsync.sum() >= 1          # the planted sync fired
    if case == "qpsk":
        assert got.minsync.sum() >= 1 and set(got.chosen.tolist()) <= {0, 2}


def test_plain_scan_matches_the_jax_kernel_in_interpret_mode():
    """The plain scan against K3 itself (the TPU kernel, interpret mode)."""
    from directdemod_tpu.ops.pll import unpack_symbol_outs
    p = pll.PskParams(**BPSK)
    x = _bpsk_stream(300_000)
    _, got = pll.symbol_scan_plain(p, torch.from_numpy(x),
                                   pll.initial_state(p, 330, device="cpu"), SYNC12, SYNC12)
    packed = np.asarray(bpsk_symbol_scan_packed(
        jpll.PskParams(**BPSK), jnp.asarray(x), 330,
        jnp.asarray(SYNC12, jnp.float32), True))
    v, a, ph, ch, m, _ = unpack_symbol_outs(packed)
    _assert_symbols(got, (a[v], ph[v], m[v], ch[v]))


@pytest.mark.parametrize("after_a", [60, 100])
def test_scan_split_into_two_blocks_equals_one(after_a):
    """Sequential block mode: the state carried to the next block with the
    anchor rebased by the block length, as the block loop does. The block
    ends 60 samples after an A sample (the next symbol's B and A both fall
    in the second block) or 100 (its B in the first: the state leaves at
    stage 1 and A replays). BPSK only: a QPSK scan uses up its step budget
    (`test_scan_budget_stops_like_jax_and_warns`), and the budget is the
    block's, so two blocks scan further than one."""
    p = pll.PskParams(**BPSK)
    x = torch.from_numpy(_bpsk_stream(300_000))
    st = pll.initial_state(p, 330, device="cpu")
    whole_st, whole = pll.symbol_scan(p, x, st, SYNC12, SYNC12)
    split = int(whole.a_idx[800]) + after_a
    st1, first = pll.symbol_scan(p, x[:split], st, SYNC12, SYNC12)
    assert int(st1["i"][0, pll.I_STAGE]) == (after_a == 100)
    st1["i"][:, pll.I_ANCHOR] -= split
    st2, second = pll.symbol_scan(p, x[split:], st1, SYNC12, SYNC12)
    assert first.count == 801
    for a, b, c in zip(whole, first, second):
        if a.dtype == torch.int64:
            c = c + split
        assert torch.equal(a, torch.cat([b, c]))
    st2["i"][:, pll.I_ANCHOR] += split
    assert torch.equal(st2["f"], whole_st["f"]) and torch.equal(st2["i"], whole_st["i"])


def test_segmented_scan_matches_jax_segments_core():
    p = pll.PskParams(**BPSK)
    jp = jpll.PskParams(**BPSK)
    x = _bpsk_stream(600_000)
    syms, seg, owned = pll.symbol_scan_segments(p, torch.from_numpy(x), SYNC12,
                                                SYNC12, 4, 500, 0)
    outs, jowned = jpll._segments_core(
        jp, jnp.asarray(x), (jnp.asarray(SYNC12, jnp.float32),
                             jnp.asarray(SYNC12, jnp.float32)), 4, 500, 0)
    v = np.asarray(outs.valid)
    want = [np.asarray(t)[v] for t in (outs.a_idx, outs.phase_out, outs.minsync,
                                       outs.chosen)]
    _assert_symbols(syms, want)
    assert np.array_equal(seg.numpy(), np.nonzero(v)[0])
    assert np.array_equal(owned.numpy(), np.asarray(jowned)[v])
    # the owned symbols tile the stream once: ~n / T of them
    assert abs(int(owned.sum()) - 600_000 / p.symbol_period) < 10


def test_scan_budget_stops_like_jax_and_warns(caplog):
    """The Meteor recurrence's timing can run backwards, so its scans use up
    the JAX scan's step budget: the port stops at the same symbol and says
    so."""
    p = pll.PskParams(**QPSK)
    x = _qpsk_stream()
    with caplog.at_level("WARNING"):
        _, got = pll.symbol_scan(p, torch.from_numpy(x),
                                 pll.initial_state(p, 120, device="cpu"), MS, MS1)
    assert got.count == pll.max_symbols(p, len(x))
    assert "step budget" in caplog.text


def test_scan_rejects_bad_arguments():
    p = pll.PskParams(**BPSK)
    x = torch.zeros(1000, dtype=torch.complex64)
    st = pll.initial_state(p, 330, device="cpu")
    with pytest.raises(ValueError):
        pll.symbol_scan(p, x.real.contiguous(), st, SYNC12, SYNC12)
    with pytest.raises(ValueError):
        pll.symbol_scan(p, x, st, SYNC12, SYNC12[:-1])
    with pytest.raises(ValueError):
        pll.symbol_scan(p, x, st, SYNC12 * 2, SYNC12)
    with pytest.raises(ValueError):
        pll.symbol_scan(p, x.to("meta"), st, SYNC12, SYNC12)
    with pytest.raises(ValueError):
        pll.initial_state(p, pll.MAX_SYNC_BITS + 1, device="cpu")


# ------------------------------------------------------------------- pass 2

def _port_replay(needle, cap, arm_pre, arm_end):
    """A detector with the fixture's config and its pass 2, on the CPU."""
    det = object.__new__(psk_sync.PskSyncDetector)
    det.cfg = psk_sync._SyncConfig(
        sym_sync=np.zeros(4), sym_sync_alt=np.zeros(4), needles=[needle],
        entries_per_sample=1, cap_entries=cap, arm_pre_syms=arm_pre,
        arm_end_syms=arm_end, frame_spacing=1e9, spacing_tol=1.0)
    det._init_device("cpu")
    det._useful = 0
    return det, psk_sync._Pass2(det)


def _fixture_symbols(minsyncs, a_idx, phases, chosens, lo=0, hi=None):
    """The fixture's symbols [lo, hi) as a scan returns them (float32
    phases)."""
    flags = np.zeros(len(a_idx), bool)
    flags[[c - 1 for c, _ in minsyncs]] = True
    return pll.Symbols(*(torch.from_numpy(np.ascontiguousarray(v[lo:hi]))
                         for v in (a_idx, phases.astype(np.float32), flags,
                                   chosens)))


@pytest.mark.parametrize("trigger_ctrs", [{41, 76}, {41, 66}, {41, 76, 78}])
def test_replay_matches_reference_buffer_oracle(trigger_ctrs):
    (needle, cap, arm_pre, arm_end, sym_samples, vals, stream,
     minsyncs, a_idx, phases, chosens) = _arming_fixture(trigger_ctrs)
    want = _reference_buffer_oracle(vals, sym_samples, trigger_ctrs, needle,
                                    cap, arm_pre, arm_end)
    det, p2 = _port_replay(needle, cap, arm_pre, arm_end)
    p2.add_block(torch.from_numpy(stream), 0,
                 _fixture_symbols(minsyncs, a_idx, phases, chosens), 0, final=True)
    got = p2.syncs()
    assert got == want
    # the whole capture's product: the syncs after the first, one batch
    assert det._finalize(got) == want[1:] and det.useful == 0
    assert det.counters["psk.pass2.batches"] == 1
    assert det.counters["psk.pass2.correlations"] == len(want)


def test_replay_stale_window_across_chunk_boundary():
    trigger_ctrs = {41, 76}
    (needle, cap, arm_pre, arm_end, sym_samples, vals, stream,
     minsyncs, a_idx, phases, chosens) = _arming_fixture(trigger_ctrs)
    want = _reference_buffer_oracle(vals, sym_samples, trigger_ctrs, needle,
                                    cap, arm_pre, arm_end)
    det, p2 = _port_replay(needle, cap, arm_pre, arm_end)
    split = int(sym_samples[71]) + 5
    n_sym1 = int(np.searchsorted(sym_samples, split))
    p2.add_block(torch.from_numpy(stream[:split]), 0,
                 _fixture_symbols(minsyncs, a_idx, phases, chosens, 0, n_sym1),
                 0, final=False)
    # the first block's stale snapshot is quantized in its own batch; the
    # retained stream keeps only the tail a window can reach
    assert p2._stale is not None and p2._stale.vals is not None
    assert p2.stream.lo == 0 and det.counters["psk.pass2.windows"] == 2
    p2.add_block(torch.from_numpy(stream[split:]), split,
                 _fixture_symbols(minsyncs, a_idx, phases, chosens, n_sym1),
                 0, final=True)
    assert p2.syncs() == want


# ------------------------------------------------------------------- decoders

@pytest.fixture(scope="module")
def funcube_capture():
    spacing = K.FUNCUBE_FRAME_SPACING_S
    return _bpsk_capture([2.0, 2.0 + spacing], dur_s=2.0 + spacing + 1.2)


@pytest.fixture(scope="module")
def jax_funcube(funcube_capture):
    out = {}
    for segs in (None, 4):
        d = JFuncube(JArraySource(funcube_capture, FS), 5000, n_segments=segs)
        out[segs] = (d.get_syncs(), d.useful)
    return out


@pytest.mark.parametrize("segs", [None, 4])
def test_funcube_decoder_matches_jax(funcube_capture, jax_funcube, segs):
    dec = FuncubeDecoder(ArraySource(funcube_capture, FS), 5000, n_segments=segs,
                         device="cpu")
    syncs = dec.get_syncs()
    assert (syncs, dec.useful) == jax_funcube[segs]
    assert dec.useful == 1 and len(syncs) == 1
    assert set(dec.stage_seconds) == {"frontend", "symbol_scan", "pass2"}


def test_funcube_block_loop_matches_whole_capture(funcube_capture, jax_funcube):
    """Small stream blocks: the scan state, minsync clusters and the
    correlation windows cross block boundaries; raw bytes held in a
    DeviceRawSource take the blocked feed."""
    iq = funcube_capture
    raw = np.empty(2 * len(iq), np.uint8)
    raw[0::2] = np.clip(np.round(iq.real + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag + 127.5), 0, 255)
    src = DeviceRawSource(torch.from_numpy(raw), FS)
    whole = FuncubeDecoder(src, 5000, device="cpu")
    small = FuncubeDecoder(src, 5000, block_size=1_000_000, device="cpu")
    sw, ss = whole.get_syncs(), small.get_syncs()
    assert whole.useful == small.useful == 1 and len(sw) == len(ss) == 1
    assert abs(sw[0] - ss[0]) < 0.01 * FS
    assert abs(sw[0] - jax_funcube[None][0][0]) < 0.01 * FS


def test_meteor_decoder_matches_jax():
    frames = [0.5 + i * K.METEOR_FRAME_SPACING_S for i in range(5)]
    cap = _qpsk_capture(frames, dur_s=1.4)
    jd = JMeteor(JArraySource(cap, FS), 4000)
    want = jd.get_syncs()
    dec = MeteorM2Decoder(ArraySource(cap, FS), 4000, device="cpu")
    assert dec.get_syncs() == want
    assert dec.useful == jd.useful == 1 and len(want) >= 2


@pytest.fixture(scope="module")
def doppler_file(tmp_path_factory):
    """tests/test_psk_sync.py::test_funcube_doppler_corrected's capture."""
    spacing = K.FUNCUBE_FRAME_SPACING_S
    cap = _bpsk_capture([1.5, 1.5 + spacing], dur_s=1.5 + spacing + 1.0,
                        offset_hz=5000.0, carrier_err=3000.0)
    raw = np.empty(2 * len(cap), np.uint8)
    raw[0::2] = np.clip(np.round(cap.real + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(cap.imag + 127.5), 0, 255)
    p = str(tmp_path_factory.mktemp("psk") / "fc.dat")
    raw.tofile(p)
    return p


def test_doppler_track_matches_jax(doppler_file):
    raw = np.fromfile(doppler_file, np.uint8)
    args = (FS, 145_865_000, 145_870_000, 20000)
    got = doppler.find_shift(raw, *args, device="cpu")
    want = jdoppler.find_shift(raw, *args)
    assert got.shape == want.shape and len(got) > 5
    assert np.max(np.abs(got - want)) <= 250.0
    # a track from the bytes held as a tensor (the resident path) is the same
    assert np.array_equal(doppler.find_shift(torch.from_numpy(raw), *args, device="cpu"), got)


def test_doppler_corrected_decoder_matches_jax(doppler_file):
    center, chan = 145_865_000, 145_870_000
    jd = JFuncube(JIQDat(doppler_file, FS), 5000, center_frequency=center,
                  signal_freq=chan, corrfreq=True)
    want = jd.get_syncs()
    dec = FuncubeDecoder(IQDat(doppler_file, FS), 5000, center_frequency=center,
                         signal_freq=chan, corrfreq=True, device="cpu")
    got = dec.get_syncs()
    assert dec.useful == jd.useful == 1 and len(got) == len(want) >= 1
    assert np.max(np.abs(np.subtract(got, want))) < 0.01 * FS
    assert jK.FUNCUBE_FRAME_SPACING_S == K.FUNCUBE_FRAME_SPACING_S
