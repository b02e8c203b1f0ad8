"""The port against the JAX decoders on adversarial synthetic captures: the
counterpart of tests/test_adversarial.py (NOAA deep in the noise and past
its usefulness cliff, a Doppler-ramped pass, the AFSK SNR sweep, a partial
frame before a whole one, Funcube on noise only), held to the JAX decoder
on the same input rather than to the reference tree.

The full cases are `slow`, as in the JAX file; one cheap case of each kind
runs in tier-1.

Stated tolerances (the JAX file's own bars, port against JAX):
- NOAA: usefulness equal; crude syncs the same count and within 2 samples;
  past the cliff (-16 dB) both useless;
- the Doppler ramp (60 Hz/s): both useful, syncs within 2 samples, the
  JAX file's spacing and image checks on the port's decode;
- AFSK: the same payloads decoded at each SNR, or the same clean failure
  (no message, or usefulness 0) on both sides; the partial frame rejected
  and the whole one decoded by both;
- Funcube on noise only: both `useful == 0`.
"""
import numpy as np
import pytest
import torch

from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.models.afsk1200 import Afsk1200Decoder as JAfsk
from directdemod_tpu.models.funcube import FuncubeDecoder as JFuncube
from directdemod_tpu.models.noaa import NoaaDecoder as JNoaa
from directdemod_tpu_torch.io.sources import ArraySource
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from tests.apt_synth import FS, synthesize
from tests.test_adversarial import _afsk_iq
from tests.test_afsk1200 import afsk_modulate, make_ax25_frame, stuff_bits

torch.set_num_threads(1)

FLAGS = [0, 1, 1, 1, 1, 1, 1, 0]


def _noaa_pair(iq):
    dec = NoaaDecoder(ArraySource(iq, FS), 30000, device="cpu")
    jdec = JNoaa(JArraySource(iq, FS), 30000)
    return dec, jdec


def _syncs_close(dec, jdec):
    for got, ref in zip(dec.get_crude_sync(), jdec.get_crude_sync()):
        ref = np.asarray(ref)
        assert len(got) == len(ref)
        if len(ref):
            assert np.max(np.abs(np.asarray(got) - ref)) <= 2


# ------------------------------------------------------------------ NOAA

@pytest.mark.parametrize("snr_db", [
    -8, pytest.param(-12, marks=pytest.mark.slow)])
def test_noaa_deep_noise_parity(snr_db):
    """Deep in the noise both decoders keep the pass: usefulness equal (1)
    and crude syncs within 2 samples."""
    iq, _ = synthesize(n_lines=12, snr_db=snr_db)
    dec, jdec = _noaa_pair(iq)
    assert dec.useful == jdec.useful == 1
    _syncs_close(dec, jdec)


@pytest.mark.parametrize("snr_db", [-16, pytest.param(-20, marks=pytest.mark.slow)])
def test_noaa_below_threshold_agrees(snr_db):
    """Past the cliff both say 'no NOAA here' (ref decode_noaa.py:793-804).
    The cliff is soft: at -16 dB another noise seed (1) lets both decoders
    find ten spaced syncs, so the cases keep the JAX file's seed."""
    iq, _ = synthesize(n_lines=12, snr_db=snr_db)
    dec, jdec = _noaa_pair(iq)
    assert dec.useful == jdec.useful == 0


@pytest.mark.parametrize("n_lines", [12, pytest.param(24, marks=pytest.mark.slow)])
def test_noaa_doppler_ramp(n_lines):
    """A 60 Hz/s carrier drift (the top of the LEO pass range at 137 MHz):
    syncs within 2 samples of JAX's, and the JAX file's own checks on the
    port's decode."""
    iq, _ = synthesize(n_lines=n_lines, snr_db=12, doppler_hz_per_s=60.0)
    dec, jdec = _noaa_pair(iq)
    assert dec.useful == jdec.useful == 1
    _syncs_close(dec, jdec)
    sa, _ = dec.get_crude_sync()
    assert len(sa) >= n_lines - 1
    assert np.all(np.abs(np.diff(sa) - 0.5 * 60235) < 5)
    img = dec.get_image()
    assert img.shape[1] == 2080 and img.shape[0] >= n_lines - 2
    mid = img[img.shape[0] // 2, 40:1040].astype(float)
    assert np.corrcoef(mid, np.arange(mid.size))[0, 1] > 0.8


# ------------------------------------------------------------------ AFSK

def _afsk_outcome(dec) -> tuple:
    msg = dec.get_msg()
    return ("clean failure" if msg in ("", None) or dec.useful == 0 else msg), dec.useful


@pytest.mark.parametrize("snr_db", [
    5, pytest.param(20, marks=pytest.mark.slow), pytest.param(10, marks=pytest.mark.slow),
    pytest.param(-6, marks=pytest.mark.slow)])
def test_afsk_snr_sweep_parity(snr_db):
    """The same payload decoded at each SNR, or the same clean failure;
    never a corrupted 'successful' message (the CRC gate)."""
    iq = _afsk_iq("snr check", snr_db=snr_db)
    got = _afsk_outcome(Afsk1200Decoder(ArraySource(iq, FS), 12000, device="cpu"))
    want = _afsk_outcome(JAfsk(JArraySource(iq, FS), 12000))
    assert got == want
    assert got[0] in ("snr check", "clean failure")
    if snr_db >= 10:
        assert got[0] == "snr check"


@pytest.mark.parametrize("cut", [3, pytest.param(2, marks=pytest.mark.slow)])
def test_afsk_partial_then_whole_frame(cut):
    """A frame truncated to 1/`cut` of its bits, then a whole one: both
    decoders reject the first (CRC) and recover the second."""
    whole = stuff_bits(make_ax25_frame(info="good frame"))
    wire = FLAGS * 2 + whole[: len(whole) // cut] + FLAGS * 3 + whole + FLAGS * 3
    iq = afsk_modulate(wire, FS, offset_hz=12000)
    dec = Afsk1200Decoder(ArraySource(iq, FS), 12000, device="cpu")
    jdec = JAfsk(JArraySource(iq, FS), 12000)
    assert dec.get_msg() == jdec.get_msg() == "good frame"
    assert dec.useful == jdec.useful == 1
    assert [f.info for f in dec.get_frames()] == ["good frame"]


# ------------------------------------------------------------------- PSK

@pytest.mark.parametrize("seconds", [1.0, pytest.param(2.0, marks=pytest.mark.slow)])
def test_funcube_noise_only(seconds):
    """Pure noise: neither decoder finds a useful Funcube capture."""
    rng = np.random.default_rng(3)
    n = int(seconds * FS)
    iq = (60.0 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    dec = FuncubeDecoder(ArraySource(iq, FS), 5000, device="cpu")
    jdec = JFuncube(JArraySource(iq, FS), 5000)
    syncs, jsyncs = dec.get_syncs(), jdec.get_syncs()
    assert dec.useful == jdec.useful == 0
    assert len(syncs) <= 2 and len(jsyncs) <= 2
