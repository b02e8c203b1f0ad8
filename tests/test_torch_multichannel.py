"""The port's one-pass multichannel front end (`models/multichannel.py`)
against the JAX `MultiDdcFm.process`, on complex samples and on raw bytes
from a file, and each channel against the port's single-channel front end.

Stated tolerances: fp32 phase outputs as in tests/test_torch_stream.py
(wrapped differences, 99.9th percentile < 1e-4 rad, max < 2e-2 rad); the
complex stream (fm=False) within 1e-5 of its largest magnitude; complex128
within 1e-9. A channel against the single-channel front end at its offset:
the same per-channel arithmetic everywhere except that the plain K1 takes
all channels' byte taps in one matrix product (another summation blocking
on the CPU), so within 1e-6 rad; on the card the kernel's channel loop
keeps each output's arithmetic and the two are equal bit for bit
(tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import IQDat as JIQDat
from directdemod_tpu.models.multichannel import MultiDdcFm as JMultiDdcFm
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu_torch.io.sources import ArraySource, DeviceRawSource, IQDat
from directdemod_tpu_torch.models.frontend import DdcFm
from directdemod_tpu_torch.models.multichannel import MultiDdcFm
from directdemod_tpu_torch.ops import ddc, design

torch.set_num_threads(1)

FS = 2048000
# one recording centred at 137.5 MHz holds NOAA-15, -18 and -19
FREQS = (120_000, 412_500, -400_000)


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64)
                                        - np.asarray(b, np.float64)))))


def _assert_phase_close(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = _wrapped(got, ref)
    assert np.percentile(d, 99.9) < 1e-4, np.percentile(d, 99.9)
    assert d.max() < 2e-2, d.max()


@pytest.fixture(scope="module")
def capture():
    """Three FM carriers at FREQS plus noise, and its bytes."""
    rng = np.random.default_rng(5)
    n = 330_017
    t = np.arange(n) / FS
    x = sum(30 * np.exp(1j * (2 * np.pi * f * t + 2 * np.sin(2 * np.pi * (500 + i * 300) * t)))
            for i, f in enumerate(FREQS))
    x = x + 3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    raw = np.empty(2 * n, np.uint8)
    raw[0::2] = np.clip(np.round(x.real + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(x.imag + 127.5), 0, 255)
    return x.astype(np.complex64), raw


def _pair(fm=True):
    taps = design.blackmanharris(151)
    return (MultiDdcFm(FS, FREQS, taps, 60000, fm=fm),
            JMultiDdcFm(FS, FREQS, jdesign.blackmanharris(151), 60000, fm=fm))


def test_constants_match_jax():
    m, jm = _pair()
    assert m.channels == 3 and m.stride == jm.stride and m.out_rate == jm.out_rate
    assert np.array_equal(m.taps_mod, jm.taps_mod)
    assert np.array_equal(m.rot, jm.rots) and np.array_equal(m.hist0, jm.hist0)


@pytest.mark.parametrize("fm,dtype", [(True, "complex64"), (False, "complex64"),
                                      (True, "complex128")])
def test_array_source_matches_jax(capture, fm, dtype):
    x, _ = capture
    m, jm = _pair(fm)
    before = ddc.LAUNCHES_C64
    got, rate = m.process(ArraySource(x, FS), block_size=100_000, device="cpu",
                          dtype=getattr(torch, dtype))
    want, jrate = jm.process(JArraySource(x, FS), block_size=100_000,
                             dtype=getattr(jnp, dtype))
    assert ddc.LAUNCHES_C64 == before           # the CPU launches nothing
    assert rate == jrate and got.shape == want.shape and got.shape[0] == 3
    if dtype == "complex128":
        assert np.max(np.abs(got - want)) < 1e-9
    elif fm:
        _assert_phase_close(got, want)
    else:
        assert np.max(np.abs(got - want)) < 1e-5 * np.max(np.abs(want))


def test_iqdat_matches_jax(capture, tmp_path):
    """Raw bytes from a file: block 0's history outputs by the small conv,
    the rest of every block through K1's plain version, all channels in one
    call a block."""
    _, raw = capture
    p = tmp_path / "m.dat"
    raw.tofile(p)
    m, jm = _pair()
    got, rate = m.process(IQDat(str(p), FS), block_size=100_000, device="cpu")
    want, jrate = jm.process(JIQDat(str(p), FS), block_size=100_000)
    assert rate == jrate
    _assert_phase_close(got, want)


def test_each_channel_is_the_single_channel_front_end(capture):
    """Each channel of the bank against `DdcFm.process` at its offset, on
    the same raw bytes held in a DeviceRawSource and on complex samples."""
    x, raw = capture
    m, _ = _pair()
    for src in (DeviceRawSource(torch.from_numpy(raw), FS), ArraySource(x, FS)):
        bank, _ = m.process(src, block_size=120_000, device="cpu")
        for ch, f in enumerate(FREQS):
            one, _ = DdcFm(FS, f, design.blackmanharris(151), 60000).process(
                src, block_size=120_000, device="cpu")
            assert one.shape == bank[ch].shape
            assert _wrapped(bank[ch], one).max() < 1e-6


def test_resident_frontend_of_a_bank(capture):
    """The bank over a whole capture as one block equals the blocked run."""
    _, raw = capture
    m, _ = _pair()
    n = len(raw) // 2
    whole = m.resident_frontend(torch.from_numpy(raw), n).numpy()
    blocked, _ = m.process(DeviceRawSource(torch.from_numpy(raw), FS),
                           block_size=50_000, device="cpu")
    assert whole.shape == blocked.shape == (3, -(-n // m.stride) - 1)
    _assert_phase_close(whole, blocked)
