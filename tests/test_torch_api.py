"""The public names of the ported modules that the JAX package's own tests,
tutorials and examples call, each against its JAX counterpart on the same
input: the sources' kinds, `limitData`, `IQWavAlt` and
`DeviceRawSource.from_file`; `write_wav` and `show_image`; `butter`,
`lfiltic` and `step_history_equivalent`; `IirFilter.from_ba` and
`initial_state_zero`; `unpack.supports_raw`; the front end's functional
block API (`init_state`, `block_out_len`, `process_block`) with a
checkpoint round trip; `MultiDdcFm.init_state`. Counterparts of
tests/test_io.py:36-79,122-155, tests/test_api.py:78-112 and
tests/test_design.py:31,112.

Stated tolerances: sources, sinks and design are host NumPy copies, so
values and files are equal (design to SciPy as tests/test_design.py holds
it: rtol 1e-8 / atol 1e-14 for (b, a), 1e-12 for lfiltic); the block API
in complex128 within 1e-9 of JAX's (the sequential stream tests' bar), and
equal bit for bit to the port's own `DdcFm.process` and across a
checkpoint; the raw and complex feeds within 1e-6 (tests/test_io.py:158);
the from_ba filter within 1e-9 of JAX's in float64."""
import struct

import numpy as np
import pytest
import scipy.signal as ss
import torch
import jax.numpy as jnp

from directdemod_tpu import constants as jK
from directdemod_tpu.io import sinks as jsinks, sources as jsources
from directdemod_tpu.io.feeder import BlockFeeder as JBlockFeeder
from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.models.multichannel import MultiDdcFm as JMultiDdcFm
from directdemod_tpu.ops import design as jdesign, iir as jiir, unpack as junpack
from directdemod_tpu.stream import checkpoint as jcheckpoint
from directdemod_tpu.stream.plan import plan_blocks
from directdemod_tpu_torch import constants as K
from directdemod_tpu_torch.io import sinks, sources
from directdemod_tpu_torch.io.feeder import BlockFeeder
from directdemod_tpu_torch.models.frontend import DdcFm
from directdemod_tpu_torch.models.multichannel import MultiDdcFm
from directdemod_tpu_torch.ops import design, iir, unpack
from directdemod_tpu_torch.stream import checkpoint

torch.set_num_threads(1)

FS = 2048000


def _write_iq_wav(path, iq_u8, rate=2048000):
    payload = iq_u8.tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 2, rate, rate * 2, 2, 8))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


@pytest.fixture
def iq_bytes(rng):
    return rng.integers(0, 256, size=2 * 5000, dtype=np.uint8)


# --------------------------------------------------------------- sources

def test_source_kinds_match_jax(tmp_path, iq_bytes):
    w, d = str(tmp_path / "a.wav"), str(tmp_path / "a.dat")
    _write_iq_wav(w, iq_bytes, rate=1_024_000)
    iq_bytes.tofile(d)
    pairs = [(sources.IQWav(w), jsources.IQWav(w)),
             (sources.IQWavAlt(w), jsources.IQWavAlt(w)),
             (sources.IQDat(d), jsources.IQDat(d)),
             (sources.ArraySource(np.zeros(8, np.complex64), FS),
              jsources.ArraySource(np.zeros(8, np.complex64), FS)),
             (sources.DeviceRawSource.from_file(d, FS, device="cpu"),
              jsources.DeviceRawSource.from_file(d, FS))]
    assert (K.SOURCE_IQWAV, K.SOURCE_IQDAT) == (jK.SOURCE_IQWAV, jK.SOURCE_IQDAT)
    for ours, ref in pairs:
        assert ours.sourceType == ours.source_type == ref.sourceType == ref.source_type
        assert ours.sampFreq == ref.sampFreq and ours.length == ref.length
    assert pairs[0][0].sourceType == K.SOURCE_IQWAV
    assert pairs[2][0].sourceType == K.SOURCE_IQDAT


def test_iqwavalt_reads_as_iqwav(tmp_path, iq_bytes):
    """tests/test_io.py:47-57: the header-skipping reader reads what IQWav
    reads, at the SDR's default rate, as the JAX reader does."""
    w = str(tmp_path / "b.wav")
    _write_iq_wav(w, iq_bytes, rate=1_024_000)
    alt = sources.IQWavAlt(w)
    assert alt.sampFreq == int(K.IQ_SDRSAMPRATE) == jsources.IQWavAlt(w).sampFreq
    assert np.array_equal(alt.read(0, 100), sources.IQWav(w).read(0, 100))
    assert np.array_equal(alt.read(0, 100), jsources.IQWavAlt(w).read(0, 100))
    assert sources.IQWavAlt(w, 48000).sampFreq == 48000


@pytest.mark.parametrize("kind", ["wav", "dat", "array", "device"])
def test_limitdata_is_limit(tmp_path, iq_bytes, kind):
    d = str(tmp_path / "a.dat")
    iq_bytes.tofile(d)
    make = {"wav": lambda m: m.IQWavAlt(d),
            "dat": lambda m: m.IQDat(d),
            "array": lambda m: m.ArraySource(np.arange(5000, dtype=np.complex64), FS),
            "device": None}[kind]
    if kind == "device":
        ours = sources.DeviceRawSource.from_file(d, FS, device="cpu")
        ref = jsources.DeviceRawSource.from_file(d, FS)
    else:
        ours, ref = make(sources), make(jsources)
    ours.limitData(100, 300)
    ref.limitData(100, 300)
    assert ours.length == ref.length == 200
    if kind == "device":
        assert np.array_equal(ours.read_raw(0, 50), np.asarray(ref.read_raw(0, 50)))
    else:
        assert np.array_equal(ours.read(0, 50), ref.read(0, 50))


def test_device_raw_source_from_file(tmp_path, iq_bytes):
    d = str(tmp_path / "a.dat")
    iq_bytes.tofile(d)
    ours = sources.DeviceRawSource.from_file(d, FS, device="cpu")
    ref = jsources.DeviceRawSource.from_file(d, FS)
    assert ours.device == torch.device("cpu")
    assert np.array_equal(ours.read_raw(10, 20), np.asarray(ref.read_raw(10, 20)))
    assert np.array_equal(ours.read(10, 20), ref.read(10, 20))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sources.DeviceRawSource.from_file(d, FS)       # the device rule


def test_supports_raw_matches_jax(tmp_path, iq_bytes):
    d = str(tmp_path / "a.dat")
    iq_bytes.tofile(d)
    cases = [(sources.IQDat(d), jsources.IQDat(d)),
             (sources.DeviceRawSource.from_file(d, FS, device="cpu"),
              jsources.DeviceRawSource.from_file(d, FS)),
             (sources.ArraySource(np.zeros(4), 1000), jsources.ArraySource(np.zeros(4), 1000))]
    got = [unpack.supports_raw(s) for s, _ in cases]
    assert got == [junpack.supports_raw(s) for _, s in cases] == [True, True, False]


# ----------------------------------------------------------------- sinks

@pytest.mark.parametrize("kind", ["float32", "float64", "int16", "int32", "stereo", "tensor"])
def test_write_wav_is_the_jax_file(tmp_path, rng, kind):
    """Byte for byte the JAX writer's file, and scipy reads it back."""
    sig = {"float32": rng.standard_normal(1000).astype(np.float32),
           "float64": rng.standard_normal(1000),
           "int16": rng.integers(-3000, 3000, 1000).astype(np.int16),
           "int32": rng.integers(-3000, 3000, 1000).astype(np.int32),
           "stereo": rng.standard_normal((500, 2)).astype(np.float32),
           "tensor": rng.standard_normal(1000).astype(np.float32)}[kind]
    ours, ref = tmp_path / "ours.wav", tmp_path / "ref.wav"
    sinks.write_wav(str(ours), 20800, torch.from_numpy(sig) if kind == "tensor" else sig)
    jsinks.write_wav(str(ref), 20800, sig)
    assert ours.read_bytes() == ref.read_bytes()
    import scipy.io.wavfile as wf
    rate, data = wf.read(str(ours))
    assert rate == 20800 and data.shape == sig.shape


def test_show_image_opens_the_image(monkeypatch):
    from PIL import Image
    shown = []
    monkeypatch.setattr(Image.Image, "show", lambda self, *a, **kw: shown.append(self))
    img = np.arange(12, dtype=np.uint8).reshape(3, 4)
    sinks.show_image(img)
    jsinks.show_image(img)
    assert len(shown) == 2
    assert np.array_equal(np.asarray(shown[0]), img)
    assert np.array_equal(np.asarray(shown[0]), np.asarray(shown[1]))


# ---------------------------------------------------------------- design

@pytest.mark.parametrize("args", [
    (6, 60000 / (0.5 * 2048000), "lowpass"),
    (6, 0.3, "highpass"),
    (6, [400 / (0.5 * 60235), 4400 / (0.5 * 60235)], "bandpass"),
    (6, [0.1, 0.4], "bandstop"),
])
def test_butter_matches_jax_and_scipy(args):
    b1, a1 = design.butter(*args)
    jb, ja = jdesign.butter(*args)
    assert np.array_equal(b1, jb) and np.array_equal(a1, ja)
    b2, a2 = ss.butter(*args)
    assert np.allclose(b1, b2, rtol=1e-8, atol=1e-14)
    assert np.allclose(a1, a2, rtol=1e-8, atol=1e-14)


def test_lfiltic_matches_jax_and_scipy(rng):
    b, a = ss.butter(4, 0.2)
    y, x = rng.standard_normal(3), rng.standard_normal(3)
    got = design.lfiltic(b, a, y, x)
    assert np.array_equal(got, jdesign.lfiltic(b, a, y, x))
    assert np.allclose(got, ss.lfiltic(b, a, y, x), atol=1e-12)
    assert np.allclose(design.lfiltic(b, a, y), ss.lfiltic(b, a, y), atol=1e-12)


def test_step_history_equivalent(rng):
    """tests/test_design.py:57-64: an all-ones history is the lfilter_zi
    seed of a FIR."""
    assert np.array_equal(design.step_history_equivalent(151),
                          jdesign.step_history_equivalent(151))
    b = ss.windows.blackmanharris(151)
    x = rng.standard_normal(1000)
    y1, _ = ss.lfilter(b, [1.0], x, zi=ss.lfilter_zi(b, [1.0]))
    hist = design.step_history_equivalent(151)
    y2 = np.convolve(np.concatenate([hist, x]), b)[150:150 + 1000]
    assert np.allclose(y1, y2, atol=1e-10)


# ------------------------------------------------------------------- IIR

@pytest.mark.parametrize("ba", [([0.2, 0.3], [1.0, -0.5]),
                                (ss.butter(2, 0.2)),
                                ([0.5], [1.0])])
def test_iir_from_ba_matches_jax(rng, ba):
    b, a = ba
    filt = iir.IirFilter.from_ba(b, a)
    jfilt = jiir.IirFilter.from_ba(b, a)
    assert np.array_equal(filt.sos, np.asarray(jfilt.sos))
    x = rng.standard_normal(10_000)
    z0 = filt.initial_state_zero(torch.float64, device="cpu")
    assert torch.equal(z0, torch.zeros(2, dtype=torch.float64))
    assert np.array_equal(z0.numpy(), np.asarray(jfilt.initial_state_zero(jnp.float64)))
    y, _ = filt.apply(torch.from_numpy(x), z0)
    jy, _ = jfilt.apply(jnp.asarray(x), jfilt.initial_state_zero(jnp.float64))
    assert np.max(np.abs(y.numpy() - np.asarray(jy))) < 1e-9
    assert np.allclose(y.numpy(), ss.lfilter(b, a, x), atol=1e-9)


def test_iir_from_ba_rejects_high_orders():
    b, a = ss.butter(4, 0.2)
    with pytest.raises(ValueError, match="order > 2"):
        iir.IirFilter.from_ba(b, a)
    assert iir.IirFilter.design_butter(60235, 400, 4400, kind="bandpass") \
        .initial_state_zero().shape == (2 * 6,)


# ------------------------------------------------------- the block API

@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(11)
    n = 450_017
    t = np.arange(n) / FS
    x = (np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 400 * t)))
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex128)


def _fes():
    return (DdcFm(FS, 30000, design.blackmanharris(151), 60000),
            JDdcFm(FS, 30000, jdesign.blackmanharris(151), 60000, fm=True))


@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_process_block_loop_matches_process_and_jax(capture, dtype):
    """tests/test_api.py:84-95's block loop: bit for bit the port's
    `DdcFm.process`; JAX's loop within 1e-9 (complex128) or the front-end
    tests' wrapped-phase bar (complex64, where the port runs K4's plain
    version)."""
    fe, jfe = _fes()
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    src = sources.ArraySource(capture, FS)
    blocks = plan_blocks(len(capture), 100_000)
    state = fe.init_state(tdt, device="cpu")
    jstate = jfe.init_state(jdt)
    assert state[0].shape == (150,) and state[1].shape == (1,)
    assert np.array_equal(state[0].numpy(), np.asarray(jstate[0]))
    ours, ref = [], []
    for s, e in blocks:
        x = src.read(s, e)
        assert fe.block_out_len(s, e - s) == jfe.block_out_len(s, e - s)
        y, state = fe.process_block(torch.from_numpy(x).to(tdt), state, s)
        jy, jstate = jfe.process_block(jnp.asarray(x, dtype=jdt), jstate, s)
        assert y.shape[0] == fe.block_out_len(s, e - s) - (s == 0)
        ours.append(y.numpy())
        ref.append(np.asarray(jy))
    ours, ref = np.concatenate(ours), np.concatenate(ref)
    whole, _ = fe.process(src, block_size=100_000, device="cpu", dtype=tdt)
    assert np.array_equal(ours, whole)
    d = np.abs(np.angle(np.exp(1j * (ours.astype(np.float64) - ref))))
    if dtype == "complex128":
        assert d.max() < 1e-9
    else:
        assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2


def test_checkpoint_resume_mid_stream(capture, tmp_path):
    """tests/test_api.py:84-115: run two blocks, checkpoint the state, restore
    it into a fresh state and finish: equal to the full run bit for bit;
    the JAX checkpoint of the same point restores here too."""
    fe, jfe = _fes()
    src = sources.ArraySource(capture, FS)
    blocks = plan_blocks(len(capture), 100_000)

    def run(state, todo):
        out = []
        for s, e in todo:
            y, state = fe.process_block(torch.from_numpy(src.read(s, e)), state, s)
            out.append(y.numpy())
        return out, state

    full, _ = run(fe.init_state(torch.complex128, "cpu"), blocks)
    out1, state = run(fe.init_state(torch.complex128, "cpu"), blocks[:2])
    ck = str(tmp_path / "stream.ckpt.npz")
    checkpoint.save(ck, state, blocks[2][0], meta={"decoder": "noaa"})
    st2, pos, meta = checkpoint.restore(ck, fe.init_state(torch.complex128, "cpu"))
    assert pos == blocks[2][0] and meta["decoder"] == "noaa"
    out2, _ = run(st2, blocks[2:])
    assert np.array_equal(np.concatenate(out1 + out2), np.concatenate(full))

    jstate = jfe.init_state(jnp.complex128)
    for s, e in blocks[:2]:
        _, jstate = jfe.process_block(jnp.asarray(src.read(s, e)), jstate, s)
    jck = str(tmp_path / "jax.ckpt.npz")
    jcheckpoint.save(jck, jstate, blocks[2][0])
    st3, pos3, _ = checkpoint.restore(jck, fe.init_state(torch.complex128, "cpu"))
    out3, _ = run(st3, blocks[2:])
    d = np.abs(np.concatenate(out3) - np.concatenate(out2))
    assert pos3 == pos and d.max() < 1e-9


def test_feeder_raw_block_loop_matches_complex(tmp_path, iq_bytes):
    """tests/test_io.py:135-158: the feed's raw uint8 blocks through
    `process_block` give the audio of its host-unpacked complex blocks,
    and the JAX loop's."""
    p = str(tmp_path / "a.dat")
    iq_bytes.tofile(p)
    src = sources.IQDat(p, 20000)
    jsrc = jsources.IQDat(p, 20000)
    fe = DdcFm(20000, 300, design.blackmanharris(151), 4000)
    jfe = JDdcFm(20000, 300, jdesign.blackmanharris(151), 4000, fm=True)
    outs, jouts = {}, {}
    for raw in (False, True):
        state = fe.init_state(torch.complex64, "cpu")
        ys = []
        for s, e, x in BlockFeeder(src, 2000, device="cpu", raw=raw):
            assert (x.dtype == torch.uint8) == raw
            y, state = fe.process_block(x, state, s)
            ys.append(y.numpy())
        outs[raw] = np.concatenate(ys)
        jstate = jfe.init_state(jnp.complex64)
        jys = []
        with JBlockFeeder(jsrc, 2000, raw=raw) as feeder:
            for s, e, x in feeder:
                y, jstate = jfe.process_block(x, jstate, s)
                jys.append(np.asarray(y))
        jouts[raw] = np.concatenate(jys)
    assert np.allclose(outs[True], outs[False], atol=1e-6)
    for raw in (False, True):
        assert np.allclose(outs[raw], jouts[raw], atol=1e-5)


def test_multichannel_init_state_matches_jax():
    freqs = (30000.0, -12000.0, 5000.0)
    bank = MultiDdcFm(FS, freqs, design.blackmanharris(151), 60000)
    jbank = JMultiDdcFm(FS, freqs, jdesign.blackmanharris(151), 60000)
    hist, c = bank.init_state(torch.complex128, device="cpu")
    jhist, jc = jbank.init_state(jnp.complex128)
    assert hist.shape == (3, 150) == jhist.shape and c.shape == (3, 1) == jc.shape
    assert np.array_equal(hist.numpy(), np.asarray(jhist))
    assert np.array_equal(c.numpy(), np.asarray(jc))


def test_bank_process_block_equals_bank_process():
    rng = np.random.default_rng(5)
    n = 320_000
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    freqs = (30000.0, -12000.0)
    bank = MultiDdcFm(FS, freqs, design.blackmanharris(151), 60000)
    want, _ = bank.process(sources.ArraySource(x, FS), 100_000, device="cpu")
    state = bank.init_state(torch.complex64, "cpu")
    ys = []
    for s, e in plan_blocks(n, 100_000):
        y, state = bank.process_block(torch.from_numpy(x[s:e]), state, s)
        ys.append(y.numpy())
    assert state[1].shape == (2, 1)
    assert np.array_equal(np.concatenate(ys, axis=1), want)
