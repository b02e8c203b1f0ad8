"""The port's whole NOAA APT decode (`models/noaa.NoaaDecoder`) against the
JAX package's on the same 12-line synthetic capture (tests/apt_synth.py).

Stated tolerances:
- crude syncs, usefulness and channel IDs: equal;
- image: equal shape, pixels within one uint8 level, at most 1 % of them
  off by one (fp32 rounding of the envelope, resample and medians moves a
  value across a quantization boundary now and then);
- accurate syncs: within +/-1 sample (the JAX package itself promises only
  that across batch shapes, tests/test_noaa.py:144-168: a flat correlation
  maximum moves by one sample under fp32 rounding); qualities and time syncs
  within 1e-3 relative."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.models import apt as japt
from directdemod_tpu.models.falsecolor import false_color as jfalse_color
from directdemod_tpu.models.noaa import NoaaDecoder as JNoaaDecoder
from directdemod_tpu_torch.io.sources import ArraySource, DeviceRawSource, IQDat
from directdemod_tpu_torch.models import apt, frontend
from directdemod_tpu_torch.models import noaa as noaa_mod
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from directdemod_tpu_torch.ops import iir
from tests.apt_synth import FS, synthesize

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def capture():
    iq, truth = synthesize(n_lines=12, snr_db=20)
    return iq, truth


@pytest.fixture(scope="module")
def pair(capture):
    iq, truth = capture
    jdec = JNoaaDecoder(JArraySource(iq, FS), 30000, dtype=jnp.complex64)
    dec = NoaaDecoder(ArraySource(iq, FS), 30000, device="cpu")
    return dec, jdec, truth


def _raw_bytes(iq):
    raw = np.empty(2 * len(iq), np.uint8)
    raw[0::2] = np.round(iq.real + 127.5).astype(np.uint8)
    raw[1::2] = np.round(iq.imag + 127.5).astype(np.uint8)
    return raw


def _assert_images_close(img, ref):
    assert img.shape == ref.shape and img.dtype == np.uint8
    d = np.abs(img.astype(np.int64) - ref.astype(np.int64))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01, (d.max(), np.mean(d > 0))


def _assert_accurate_close(got, ref):
    for i in (0, 4):                                   # A and B detections
        assert len(got[i]) == len(ref[i]) > 0
        assert np.max(np.abs(np.asarray(got[i]) - np.asarray(ref[i]))) <= 1
        assert np.allclose(got[i + 2], ref[i + 2], rtol=1e-3)      # quality
        ts_g = [t for t in got[i + 3] if t is not None]
        ts_r = [t for t in ref[i + 3] if t is not None]
        assert np.allclose(ts_g, ts_r, rtol=1e-3)                  # time sync


def test_usefulness_and_crude_syncs_equal(pair):
    dec, jdec, _ = pair
    assert dec.useful == jdec.useful == 1
    sa, sb = dec.get_crude_sync()
    ja, jb = jdec.get_crude_sync()
    assert np.array_equal(sa, ja) and np.array_equal(sb, jb)


def test_image_and_channel_ids(pair):
    dec, jdec, truth = pair
    img = dec.get_image()
    _assert_images_close(img, jdec.get_image())
    assert dec.channel_id == jdec.channel_id
    assert dec.image_a.shape[1] == dec.image_b.shape[1] == 1040
    gt = truth[0][40:1040]
    cors = [np.corrcoef(img[r, :1040].astype(np.float64)[60:1000], gt[60:1000])[0, 1]
            for r in range(img.shape[0])]
    assert np.median(cors) > 0.9


def test_false_color(pair):
    dec, _, _ = pair
    assert np.array_equal(dec.get_color(), jfalse_color(dec.image_a, dec.image_b))


def test_accurate_sync_fast_path(pair):
    dec, jdec, _ = pair
    got = dec.get_accurate_sync(use_norm_correlate=True)
    _assert_accurate_close(got, jdec.get_accurate_sync(use_norm_correlate=True))
    assert np.all(np.abs(np.asarray(got[1]) - 0.5 * FS) < 300)


def test_accurate_sync_generic_walk(capture, pair, monkeypatch):
    """NOAA_MINPEAKDIST just below the fast-path gate sends the port
    through the generic host walk; it must find what the JAX fast path
    finds (one peak group per window either way)."""
    iq, _ = capture
    _, jdec, _ = pair
    dec = NoaaDecoder(ArraySource(iq, FS), 30000, device="cpu")
    monkeypatch.setattr(noaa_mod.K, "NOAA_MINPEAKDIST", 0.0576)
    got = dec.get_accurate_sync(use_norm_correlate=True)
    monkeypatch.undo()
    _assert_accurate_close(got, jdec.get_accurate_sync(use_norm_correlate=True))


def test_strict_rate_audio(pair):
    dec, jdec, _ = pair
    audio, rate = dec.get_audio()
    ref, jrate = jdec.get_audio()
    assert rate == jrate == 20800 and audio.shape == ref.shape
    assert np.max(np.abs(audio - ref)) < 1e-4 * np.max(np.abs(ref))


def test_raw_source_decode_through_k1(capture, pair, monkeypatch):
    """The capture as raw bytes in a DeviceRawSource (here on the CPU), with
    block 0 shortened so the resident front end runs K1 (its plain version)
    over the remainder and accurate-sync windows are gathered from the
    bytes: the same syncs and image as the JAX decode."""
    iq, _ = capture
    _, jdec, _ = pair
    monkeypatch.setattr(frontend.constants, "PROC_CHUNKSIZE", 4_000_000)
    dec = NoaaDecoder(DeviceRawSource(torch.from_numpy(_raw_bytes(iq)), FS), 30000,
                      device="cpu")
    assert dec.device == torch.device("cpu")
    sa, sb = dec.get_crude_sync()
    ja, jb = jdec.get_crude_sync()
    assert np.array_equal(sa, ja) and np.array_equal(sb, jb)
    _assert_images_close(dec.get_image(), jdec.get_image())
    _assert_accurate_close(dec.get_accurate_sync(),
                           jdec.get_accurate_sync(use_norm_correlate=True))
    assert set(dec.stage_seconds) == {"fm_frontend", "crude_sync", "image",
                                      "accurate_sync"}


def test_one_block_plan_matches_the_block_plan(capture, tmp_path, monkeypatch):
    """The capture's bytes held in a DeviceRawSource go through the front
    end as one block; the same bytes from a .dat file go block by block
    (PROC_CHUNKSIZE cut to 3 M samples: 5 blocks). The crude syncs are
    equal and the profiler records one "fm_frontend" call of the capture's
    length against one a block. The audio is equal bit for bit but in the
    last 16 outputs of a block of the block plan: there the CPU's
    elementwise complex product and angle run their scalar tail instead of
    the vector loop and may round another way (a few ulps; on the card K1
    computes every output alike, and its test holds all of them equal)."""
    iq, _ = capture
    raw = _raw_bytes(iq)
    path = tmp_path / "apt.dat"
    raw.tofile(path)
    blk = 3_000_000
    monkeypatch.setattr(noaa_mod.K, "PROC_CHUNKSIZE", blk)
    one = NoaaDecoder(DeviceRawSource(torch.from_numpy(raw), FS), 30000,
                      device="cpu")
    blocked = NoaaDecoder(IQDat(str(path), FS), 30000, device="cpu")
    sa, sb = one.get_crude_sync()
    ba, bb = blocked.get_crude_sync()
    assert np.array_equal(sa, ba) and np.array_equal(sb, bb) and len(sa) > 0
    n = len(iq)
    for dec, calls in ((one, 1), (blocked, -(-n // blk))):
        st = dec.profiler.stages["fm_frontend"]
        assert (st.calls, st.samples) == (calls, n)
    (a1, r1), (a2, r2) = one._audio, blocked._audio
    assert r1 == r2 and a1.shape == a2.shape
    fe = one._frontend()
    ends = np.cumsum([fe.block_out_len(s, min(s + blk, n) - s)
                      for s in range(0, n, blk)]) - 1     # block 0 drops one
    assert ends[-1] == a1.shape[0]
    tails = np.zeros(a1.shape[0], bool)
    for e in ends:
        tails[e - 16:e] = True
    d = (a1 - a2).abs().numpy()
    assert not d[~tails].any() and d.max() < 1e-6


def test_noise_only_capture_is_not_useful():
    rng = np.random.default_rng(0)
    iq = (0.3 * 60 * (rng.standard_normal(FS) + 1j * rng.standard_normal(FS))) \
        .astype(np.complex64)
    dec = NoaaDecoder(ArraySource(iq, FS), 30000, device="cpu")
    jdec = JNoaaDecoder(JArraySource(iq, FS), 30000, dtype=jnp.complex64)
    assert dec.useful == jdec.useful == 0


@pytest.mark.parametrize("csync", [
    [],                                   # no syncs at all
    [12345.0],                            # single sync: no spacing estimate
    [7.0, 7.0, 7.0, 900.0],               # duplicates: modal spacing == 0
    [100.0, 30217.0, 60335.0, 120570.0],  # one missed sync to fill
])
def test_fill_syncs_and_degenerate_image(csync):
    """fill_syncs equals the JAX copy, and the image stage takes degenerate
    sync lists without raising (the backup-image path)."""
    out = apt.fill_syncs(csync, max_len=150_000)
    assert out == japt.fill_syncs(csync, max_len=150_000)
    rate = 60235
    audio = torch.from_numpy(np.random.default_rng(0).random(150_000)
                             .astype(np.float32))
    bp = iir.IirFilter.design_butter(rate, 400, 4400, order=6, kind="bandpass")
    img, _, _ = apt.assemble_image(audio, rate, out, [c + 15000 for c in out],
                                   np.asarray(out), bp, 60000)
    assert img.ndim == 2
