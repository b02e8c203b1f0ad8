"""The port's single-process mesh (`directdemod_tpu_torch.parallel`) on 8
CPU shards, as the JAX package's `tests/test_parallel.py` runs its mesh on 8
virtual CPU devices: each of that file's tests has its counterpart here,
holding the port's mesh result against the port's sequential result and
against the JAX package's sharded result on the same numpy input.

Stated tolerances (the JAX tests' own):
- front end in complex128: < 1e-9; the complex (fm=False) stream: < 1e-8
  of the output's scale; over raw bytes in complex64 (the plain K1 on the
  CPU, whose convolution may associate its sums by block): < 1e-6 rad
  against the sequential stream, and the front-end tests' wrapped phase
  bar (99.9th percentile < 1e-4, max < 2e-2) against JAX;
- sync peaks: the same count, within 1 sample;
- IIR: < 1e-9 of the output's scale in float64, 1e-5 in float32;
- envelope: < 1e-5;
- NOAA on a mesh: crude syncs equal, >= 99 % of image pixels equal, and
  accurate syncs within +/-1 sample (D12: the accurate sync agrees only to
  a sample across batch shapes); against JAX the image within one uint8
  level on under 1 % of pixels (tests/test_torch_noaa.py);
- the segment scan on a mesh: equal to the call without one, bit for bit;
- PSK decoders on a mesh: syncs and usefulness equal to the JAX decoders'
  on a mesh (tests/test_torch_psk.py).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu import constants as jK
from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import DeviceRawSource as JDeviceRawSource
from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.models.funcube import FuncubeDecoder as JFuncube
from directdemod_tpu.models.meteorm2 import MeteorM2Decoder as JMeteor
from directdemod_tpu.models.multichannel import MultiDdcFm as JMultiDdcFm
from directdemod_tpu.models.noaa import NoaaDecoder as JNoaaDecoder
from directdemod_tpu.ops import design as jdesign, iir as jiir
from directdemod_tpu.parallel import am as jpam, correlate as jpcorr, iir as jpiir
from directdemod_tpu.parallel.mesh import make_mesh as jmake_mesh
from directdemod_tpu.parallel.sharded import ShardedDdcFm as JShardedDdcFm
from directdemod_tpu.stream.api import Stream as JStream
from directdemod_tpu_torch import constants as K
from directdemod_tpu_torch.io.sources import ArraySource, DeviceRawSource
from directdemod_tpu_torch.models.frontend import DdcFm
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder
from directdemod_tpu_torch.models.multichannel import MultiDdcFm
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from directdemod_tpu_torch.ops import am as am_ops, correlate as C, design, iir, peaks
from directdemod_tpu_torch.ops import pll
from directdemod_tpu_torch.parallel import mesh as pmesh
from directdemod_tpu_torch.parallel.am import sharded_envelope_blocked
from directdemod_tpu_torch.parallel.correlate import sharded_find_sync_peaks
from directdemod_tpu_torch.parallel.dryrun import dryrun
from directdemod_tpu_torch.parallel.iir import sharded_lfilter, sharded_zero_phase
from directdemod_tpu_torch.parallel.mesh import make_mesh
from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
from directdemod_tpu_torch.stream.api import Stream
from tests.apt_synth import synthesize
from tests.test_psk_sync import _bpsk_capture, _qpsk_capture
from tests.test_torch_psk import BPSK, SYNC12

torch.set_num_threads(1)

FS = 2048000


def mesh8():
    return make_mesh(time=8, channel=1, device="cpu")


@pytest.fixture(scope="module")
def capture():
    rng = np.random.default_rng(11)
    n = 8 * 100_000 + 100_000 + 777      # 8 full waves + leftover + ragged
    t = np.arange(n) / FS
    x = (np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 400 * t)))
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex128)


def _bytes(x: np.ndarray, scale: float = 60.0) -> np.ndarray:
    b = np.empty(2 * len(x), np.uint8)
    b[0::2] = np.clip(np.round(x.real * scale + 127.5), 0, 255)
    b[1::2] = np.clip(np.round(x.imag * scale + 127.5), 0, 255)
    return b


def _wrapped(d):
    return np.abs(np.angle(np.exp(1j * np.asarray(d, np.float64))))


# ------------------------------------------------------------- front end

def test_sharded_matches_sequential_fm(capture):
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000, fm=True)
    src = ArraySource(capture, FS)
    ref, rate = fe.process(src, block_size=100_000, device="cpu",
                           dtype=torch.complex128)
    ours, rate2 = ShardedDdcFm(fe, mesh8()).process(src, block_size=100_000,
                                                    dtype=torch.complex128)
    jfe = JDdcFm(FS, 30000, jdesign.blackmanharris(151), 60000, fm=True)
    jgot, jrate = JShardedDdcFm(jfe, jmake_mesh(time=8, channel=1)).process(
        JArraySource(capture, FS), block_size=100_000, dtype=jnp.complex128)
    assert rate == rate2 == jrate
    assert len(ours) == len(ref) == len(jgot)
    assert np.max(np.abs(ours - ref)) < 1e-9
    assert np.max(np.abs(ours - jgot)) < 1e-9


def test_sharded_matches_sequential_complex_stream(capture):
    fe = DdcFm(FS, 12000, design.blackmanharris(151), 22050, fm=False)
    src = ArraySource(capture, FS)
    ref, _ = fe.process(src, block_size=100_000, device="cpu",
                        dtype=torch.complex128)
    ours, _ = ShardedDdcFm(fe, mesh8()).process(src, block_size=100_000,
                                                dtype=torch.complex128)
    jfe = JDdcFm(FS, 12000, jdesign.blackmanharris(151), 22050, fm=False)
    jgot, _ = JShardedDdcFm(jfe, jmake_mesh(time=8, channel=1)).process(
        JArraySource(capture, FS), block_size=100_000, dtype=jnp.complex128)
    assert len(ours) == len(ref) == len(jgot)
    assert np.max(np.abs(ours - ref)) < 1e-8 * np.max(np.abs(ref))
    assert np.max(np.abs(ours - jgot)) < 1e-8 * np.max(np.abs(ref))


@pytest.mark.parametrize("block,ndev", [(100_000, 8), (99_999, 8), (100_000, 3)])
def test_sharded_over_raw_bytes(capture, block, ndev):
    """A raw uint8 source: each shard takes its halo as bytes and runs K1's
    plain version on the CPU (an odd block puts the blocks at odd
    decimator phases; 3 shards leave a remainder of whole blocks)."""
    raw = _bytes(capture)
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000)
    src = DeviceRawSource(torch.from_numpy(raw), FS)
    ref, _ = fe.process(src, block_size=block, device="cpu")
    got, _ = ShardedDdcFm(fe, make_mesh(time=ndev, device="cpu")).process(
        src, block_size=block)
    assert got.shape == ref.shape
    assert _wrapped(got - ref).max() < 1e-6
    jfe = JDdcFm(FS, 30000, jdesign.blackmanharris(151), 60000)
    jgot, _ = JShardedDdcFm(jfe, jmake_mesh(time=8, channel=1)).process(
        JDeviceRawSource.from_host_bytes(raw, FS), block_size=block)
    d = _wrapped(got - jgot)
    assert len(jgot) == len(got)
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2


def test_sharded_rejects_a_short_block(capture):
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000)
    with pytest.raises(ValueError):
        ShardedDdcFm(fe, mesh8()).process(ArraySource(capture, FS), block_size=100)


# ------------------------------------------------------------------ mesh

def test_mesh_validation():
    with pytest.raises(ValueError) as port:
        make_mesh(time=3, channel=2, devices=pmesh.visible_devices("cpu"))
    with pytest.raises(ValueError) as ref:
        jmake_mesh(time=3, channel=2)
    assert str(port.value) == str(ref.value) == "3x2 mesh needs 6 devices, have 8"


def test_mesh_shape_and_devices():
    m = make_mesh(device="cpu")
    assert m.shape == {"time": 8, "channel": 1} == dict(jmake_mesh().shape)
    m = make_mesh(time=2, channel=4, device="cpu")
    assert m.shape == {"time": 2, "channel": 4}
    assert m.time_devices == [torch.device("cpu")] * 2
    assert m.channel_devices == [torch.device("cpu")] * 4
    assert pmesh.single_device_mesh("cpu").shape == {"time": 1, "channel": 1}


def test_mesh_naming_one_device_twice(capture):
    """Two shards on one device: a ppermute'd halo is a copy, not a view of
    its sender, and the sharded front end still equals the sequential one."""
    m = make_mesh(time=2, devices=["cpu", "cpu"])
    a = torch.arange(4.0)
    got = pmesh.ppermute([a, a + 10], [(0, 1)], m.time_devices)
    assert torch.equal(got[1], a) and got[1].data_ptr() != a.data_ptr()
    assert torch.equal(got[0], torch.zeros(4))
    g = pmesh.all_gather([a, a + 10], m.time_devices)
    assert torch.equal(g[0], torch.stack([a, a + 10])) and torch.equal(g[0], g[1])
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000)
    src = ArraySource(capture[:500_000], FS)
    ref, _ = fe.process(src, block_size=100_000, device="cpu",
                        dtype=torch.complex128)
    ours, _ = ShardedDdcFm(fe, m).process(src, 100_000, dtype=torch.complex128)
    assert np.max(np.abs(ours - ref)) < 1e-9


# ------------------------------------------------------------- channels

def test_multichannel_matches_per_channel(capture):
    """One-pass multi-channel DDC == independent per-channel runs (and the
    JAX bank)."""
    src = ArraySource(capture[:400_000], FS)
    freqs = (30000.0, -12000.0, 5000.0)
    got, rate = MultiDdcFm(FS, freqs, design.blackmanharris(151), 60000).process(
        src, block_size=150_000, device="cpu", dtype=torch.complex128)
    jgot, _ = JMultiDdcFm(FS, freqs, jdesign.blackmanharris(151), 60000).process(
        JArraySource(capture[:400_000], FS), block_size=150_000, dtype=jnp.complex128)
    assert got.shape[0] == 3 and got.shape == jgot.shape
    assert np.max(np.abs(got - jgot)) < 1e-9
    for ci, f in enumerate(freqs):
        fe = DdcFm(FS, f, design.blackmanharris(151), 60000)
        ref, r2 = fe.process(src, block_size=150_000, device="cpu",
                             dtype=torch.complex128)
        assert r2 == rate
        assert np.max(np.abs(got[ci] - ref)) < 1e-9, ci


def test_multichannel_on_channel_mesh(capture):
    """Channel-sharded MultiDdcFm == the unsharded one-pass run, and the
    JAX bank on its channel mesh."""
    src = ArraySource(capture[:400_000], FS)
    freqs = (30000.0, -12000.0, 5000.0, -40000.0)
    taps = design.blackmanharris(151)
    ref, rate = MultiDdcFm(FS, freqs, taps, 60000).process(
        src, block_size=150_000, device="cpu", dtype=torch.complex128)
    mesh = make_mesh(time=2, channel=4, device="cpu")
    got, rate2 = MultiDdcFm(FS, freqs, taps, 60000, mesh=mesh).process(
        src, block_size=150_000, dtype=torch.complex128)
    jgot, _ = JMultiDdcFm(FS, freqs, jdesign.blackmanharris(151), 60000,
                          mesh=jmake_mesh(time=2, channel=4)).process(
        JArraySource(capture[:400_000], FS), block_size=150_000, dtype=jnp.complex128)
    assert rate == rate2
    assert np.max(np.abs(got - ref)) < 1e-12
    assert np.max(np.abs(got - jgot)) < 1e-9


def test_multichannel_channel_count_must_divide():
    mesh = make_mesh(time=2, channel=4, device="cpu")
    taps = design.blackmanharris(151)
    with pytest.raises(ValueError, match="not divisible") as port:
        MultiDdcFm(FS, (30000.0, -12000.0, 5000.0), taps, 60000, mesh=mesh)
    with pytest.raises(ValueError) as ref:
        JMultiDdcFm(FS, (30000.0, -12000.0, 5000.0), jdesign.blackmanharris(151),
                    60000, mesh=jmake_mesh(time=2, channel=4))
    assert str(port.value) == str(ref.value)


def test_multichannel_on_channel_mesh_over_raw_bytes(capture):
    """Raw bytes to a 1 x 2 channel mesh: each shard's bank (K1's plain
    version) equals the unsharded bank's channels."""
    raw = _bytes(capture[:400_000])
    src = DeviceRawSource(torch.from_numpy(raw), FS)
    freqs = (30000.0, -12000.0)
    taps = design.blackmanharris(151)
    ref, _ = MultiDdcFm(FS, freqs, taps, 60000).process(src, 150_000, device="cpu")
    got, _ = MultiDdcFm(FS, freqs, taps, 60000,
                        mesh=make_mesh(time=1, channel=2, device="cpu")).process(src, 150_000)
    assert got.shape == ref.shape
    assert _wrapped(got - ref).max() < 1e-6


# ---------------------------------------------------------------- stream

def test_stream_run_sharded(capture):
    """The chainable API's end of the mesh path."""
    chain = (Stream(ArraySource(capture, FS), dtype=torch.complex128, device="cpu")
             .shift(30000).filter(design.blackmanharris(151)).bw_limit(60000)
             .fm_demod())
    ref, rate = chain.run_fused(block_size=100_000)
    got, rate2 = chain.run_sharded(mesh8(), block_size=100_000)
    jchain = (JStream(JArraySource(capture, FS), dtype=jnp.complex128)
              .shift(30000).filter(jdesign.blackmanharris(151)).bw_limit(60000)
              .fm_demod())
    jgot, jrate = jchain.run_sharded(jmake_mesh(time=8), block_size=100_000)
    assert rate == rate2 == jrate
    assert np.max(np.abs(got - ref)) < 1e-9
    assert np.max(np.abs(got - jgot)) < 1e-9


def test_stream_run_sharded_rejects_other_chains(capture):
    chain = Stream(ArraySource(capture, FS), device="cpu").fm_demod()
    with pytest.raises(ValueError, match="requires a shift->FIR->bw_limit") as port:
        chain.run_sharded(mesh8())
    with pytest.raises(ValueError) as ref:
        JStream(JArraySource(capture, FS)).fm_demod().run_sharded(jmake_mesh(time=8))
    assert str(port.value) == str(ref.value)


# ------------------------------------------------------------ sync search

@pytest.fixture(scope="module")
def noaa_iq():
    iq, _ = synthesize(n_lines=12, snr_db=20)
    return iq


def test_sharded_sync_correlation_matches_sequential(noaa_iq):
    """Needle-halo sharded correlation + the gathered adaptive threshold
    find the syncs of the one-device search, and of the JAX mesh's."""
    dec = NoaaDecoder(ArraySource(noaa_iq, FS), 30000, device="cpu")
    audio, rate = dec._fm_audio(K.NOAA_CRUDESYNCSAMPRATE, strict=False)
    env = am_ops.envelope_blocked(audio.float(), 60000 * 4).numpy()
    needle = C.apt_needle(K.NOAA_SYNCA, rate, K.NOAA_T, True)
    seq = peaks.find_sync_peaks(
        C.norm_correlate(torch.from_numpy(env), torch.as_tensor(needle, dtype=torch.float32)),
        rate, len(needle), K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
    got = sharded_find_sync_peaks(mesh8(), env, needle, rate,
                                  K.NOAA_PEAKHEIGHTWIGGLE, K.NOAA_MINPEAKDIST)
    jgot = jpcorr.sharded_find_sync_peaks(jmake_mesh(time=8, channel=1), env,
                                          np.asarray(needle), rate,
                                          jK.NOAA_PEAKHEIGHTWIGGLE, jK.NOAA_MINPEAKDIST)
    assert len(got) == len(seq) == len(jgot) > 0
    assert np.max(np.abs(got - seq)) <= 1
    assert np.max(np.abs(got - np.asarray(jgot))) <= 1


# ------------------------------------------------------------------ NOAA

@pytest.fixture(scope="module")
def noaa_mesh_decodes(noaa_iq):
    seq = NoaaDecoder(ArraySource(noaa_iq, FS), 30000, device="cpu")
    par = NoaaDecoder(ArraySource(noaa_iq, FS), 30000, device="cpu", mesh=mesh8())
    jpar = JNoaaDecoder(JArraySource(noaa_iq, FS), 30000,
                        mesh=jmake_mesh(time=8, channel=1))
    return seq, par, jpar


def test_noaa_decoder_on_mesh(noaa_mesh_decodes):
    """The whole NOAA decode with every stage over the mesh equals the
    sequential decode (crude syncs, >= 99 % of pixels, accurate syncs within
    a sample) and the JAX decode on its mesh."""
    seq, par, jpar = noaa_mesh_decodes
    assert par.useful == 1 == jpar.useful
    img_seq, img_par, img_j = seq.get_image(), par.get_image(), jpar.get_image()
    assert img_seq.shape == img_par.shape == img_j.shape
    for a, b, c in zip(seq.get_crude_sync(), par.get_crude_sync(), jpar.get_crude_sync()):
        assert np.array_equal(np.asarray(a), np.asarray(b))
        assert np.array_equal(np.asarray(b), np.asarray(c))
    assert np.mean(img_seq == img_par) > 0.99
    d = np.abs(img_par.astype(np.int64) - img_j)
    assert d.max() <= 1 and np.mean(d != 0) < 0.01
    acc_seq = seq.get_accurate_sync()
    acc_par = par.get_accurate_sync()
    acc_j = jpar.get_accurate_sync()
    for col in (0, 4):
        assert len(acc_seq[col]) == len(acc_par[col]) == len(acc_j[col]) > 0
        assert np.max(np.abs(np.subtract(acc_seq[col], acc_par[col]))) <= 1
        assert np.max(np.abs(np.subtract(acc_j[col], acc_par[col]))) <= 1
    assert set(par.stage_seconds) == {"fm_frontend", "crude_sync", "image",
                                      "accurate_sync"}


# ------------------------------------------------------------ IIR, envelope

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_iir_matches_sequential(dtype):
    """Exact sharded lfilter / filtfilt == the one-device SOS engine and
    the JAX mesh's."""
    rng = np.random.default_rng(3)
    filt = iir.IirFilter.design_butter(60235, 400, 4400, order=6, kind="bandpass")
    jfilt = jiir.IirFilter.design_butter(60235, 400, 4400, order=6, kind="bandpass")
    tol = 1e-9 if dtype == np.float64 else 1e-5
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    jmesh = jmake_mesh(time=8, channel=1)
    for n in (100_000, 100_003):        # even split + ragged tail
        x = rng.standard_normal(n).astype(dtype)
        zi = filt.initial_state_step(tdt).numpy() * x[0]
        ref_y, ref_z = filt.apply(torch.from_numpy(x), torch.from_numpy(zi))
        got_y, got_z = sharded_lfilter(mesh8(), filt, x, zi)
        jy, jz = jpiir.sharded_lfilter(jmesh, jfilt, x, zi)
        scale = np.max(np.abs(ref_y.numpy()))
        assert got_y.dtype == dtype
        assert np.max(np.abs(got_y - ref_y.numpy())) < tol * scale, n
        assert np.max(np.abs(got_y - jy)) < tol * scale, n
        assert np.allclose(got_z, ref_z.numpy(), atol=tol * scale)
        assert np.allclose(got_z, jz, atol=tol * scale)
        ref_zp = filt.zero_phase(torch.from_numpy(x)).numpy()
        got_zp = sharded_zero_phase(mesh8(), filt, x)
        assert np.max(np.abs(got_zp - ref_zp)) < tol * scale, n
        assert np.max(np.abs(got_zp - jpiir.sharded_zero_phase(jmesh, jfilt, x))) \
            < tol * scale, n


def test_sharded_envelope_matches_sequential():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(7 * 2400 + 991).astype(np.float32)
    ref = am_ops.envelope_blocked(torch.from_numpy(x), 2400).numpy()
    got = sharded_envelope_blocked(mesh8(), x, 2400)
    jgot = jpam.sharded_envelope_blocked(jmake_mesh(time=8, channel=1), x, 2400)
    assert got.shape == ref.shape == jgot.shape
    assert np.max(np.abs(got - ref)) < 1e-5
    assert np.max(np.abs(got - jgot)) < 1e-5


# ----------------------------------------------------------------- PSK

def test_segment_scan_on_a_mesh_equals_no_mesh():
    """Each shard scans its own segments: the same symbols bit for bit."""
    from tests.test_pll_scalar import _bpsk_stream
    p = pll.PskParams(**BPSK)
    x = torch.from_numpy(_bpsk_stream(600_000))
    want = pll.symbol_scan_segments(p, x, SYNC12, SYNC12, 8, 500, 0)
    got = pll.symbol_scan_segments(p, x, SYNC12, SYNC12, 8, 500, 0,
                                   mesh=make_mesh(time=4, device="cpu"))
    for w, g in zip(want[0], got[0]):
        assert torch.equal(w, g)
    assert torch.equal(want[1], got[1]) and torch.equal(want[2], got[2])
    assert want[0].a_idx.shape[0] > 1000


def test_segment_scan_segments_must_divide_the_mesh():
    """As the JAX mesh's sharding raises for 5 segments on 8 devices."""
    p = pll.PskParams(**BPSK)
    x = torch.zeros(40_000, dtype=torch.complex64)
    with pytest.raises(ValueError, match="not divisible"):
        pll.symbol_scan_segments(p, x, SYNC12, SYNC12, 5, 8, mesh=mesh8())


@pytest.fixture(scope="module")
def funcube_capture():
    return _bpsk_capture([2.0, 2.0 + K.FUNCUBE_FRAME_SPACING_S],
                         dur_s=2.0 + K.FUNCUBE_FRAME_SPACING_S + 1.2)


def test_funcube_decoder_on_mesh_matches_jax(funcube_capture):
    """n_segments defaults to the mesh's 8 shards, in the block loop."""
    jd = JFuncube(JArraySource(funcube_capture, FS), 5000,
                  mesh=jmake_mesh(time=8, channel=1))
    want = jd.get_syncs()
    dec = FuncubeDecoder(ArraySource(funcube_capture, FS), 5000, device="cpu",
                         mesh=mesh8())
    assert dec.n_segments == 8
    assert (dec.get_syncs(), dec.useful) == (want, jd.useful)
    assert dec.useful == 1 and len(want) == 1


def test_meteor_decoder_on_mesh_matches_jax():
    frames = [0.5 + i * K.METEOR_FRAME_SPACING_S for i in range(5)]
    cap = _qpsk_capture(frames, dur_s=1.4)
    jd = JMeteor(JArraySource(cap, FS), 4000, mesh=jmake_mesh(time=8, channel=1))
    want = jd.get_syncs()
    dec = MeteorM2Decoder(ArraySource(cap, FS), 4000, device="cpu", mesh=mesh8())
    assert dec.get_syncs() == want
    assert dec.useful == jd.useful == 1 and len(want) >= 2


# ---------------------------------------------------------------- dry run

def test_dryrun_on_eight_cpu_shards():
    out = dryrun(8, device="cpu")
    assert out["mesh"] == {"time": 4, "channel": 2}
    assert out["finite"] and out["pll_owned_symbols"] > 0 and out["syncs"]
    assert out["frontend_err"] < 1e-3 and out["multichannel_err"] < 1e-3
    assert set(out["stage_seconds"]) == {
        "frontend_sharded", "multichannel", "sync_search_sharded",
        "pll_segments_sharded", "image_filtfilt_sharded", "image_envelope_sharded"}

