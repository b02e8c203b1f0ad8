"""The port's AFSK1200/APRS slice against the JAX package on the same numpy
inputs: the lookahead walk (K2's plain version) against the JAX dense scan
and the JAX Pallas walk in interpret mode, the 'same' convolutions, the CRC
and bit layer, the baud window means, the FM audio of the front end, and
the whole decoder.

Stated tolerances:
- peaks, CRC, the bit layer, the 'same' convolutions on +/-1/0 inputs, the
  designed constants and decoded frames: equal (the walk compares float32
  values and takes float32 thresholds on both sides; the edge sums are
  small integers, exact in float32);
- window means: float32 sums of 18 values in another order, 1e-6 relative
  to the scale of bf;
- FM audio: the JAX suite's bars for fp32 phase outputs, 99.9th percentile
  of the wrapped difference < 1e-4 and max < 2e-2 (tests/test_pallas.py:86-87).
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import IQDat as JIQDat
from directdemod_tpu.models import afsk1200 as jafsk
from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.ops import crc as jcrc
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu.ops import fir as jfir
from directdemod_tpu.ops import iir as jiir
from directdemod_tpu.ops import peaks as jpeaks
from directdemod_tpu_torch import constants
from directdemod_tpu_torch.io.sources import ArraySource, DeviceRawSource
from directdemod_tpu_torch.models import afsk1200 as afsk_mod
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder, _window_means
from directdemod_tpu_torch.ops import crc, ddc, fir, peaks
from tests.test_afsk1200 import afsk_modulate, make_ax25_frame, stuff_bits

torch.set_num_threads(1)

FS, OFF = 2048000, 12000
FLAGS = [0, 1, 1, 1, 1, 1, 1, 0]


def _stress_y(n, seed):
    """|edge correlation| of a noisy square wave (tests/test_peaks_pallas.py)."""
    rng = np.random.default_rng(seed)
    bf = np.sign(np.sin(np.arange(n) / 9.0) + 0.3 * rng.standard_normal(n))
    k = np.concatenate([-np.ones(9), np.ones(9)])
    return np.abs(np.convolve(bf, k, "same") / 18).astype(np.float32)


def _wave_y(n, seed, period):
    """A noisy sine whose extrema lie `period` / 2 apart: the input for long
    lookaheads (the edge input's zero stretches never confirm a minimum
    over 500 samples)."""
    rng = np.random.default_rng(seed)
    return (np.sin(2 * np.pi * np.arange(n) / period)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _input(kind, n, seed):
    return _stress_y(n, seed) if kind == "edges" else _wave_y(n, seed, kind)


# ----------------------------------------------------------------- K2 plain version

@pytest.mark.parametrize("seed,lookahead,delta,n,kind", [
    (0, 11, 0.0, 6144, "edges"),
    (1, 11, 0.1, 6144, "edges"),
    (2, 1, 0.0, 4000, "edges"),
    (3, 1, 0.1, 4000, "edges"),
    (4, 500, 0.0, 12000, 1600),
    (5, 500, 0.2, 12000, 1600),
])
def test_walk_matches_jax_dense(seed, lookahead, delta, n, kind):
    """Against the JAX package's dense lax.scan walk (the walk K2 replaces
    off the TPU), exact."""
    y = _input(kind, n, seed)
    got = peaks.lookahead_peaks(torch.from_numpy(y), lookahead, delta)
    dense = jpeaks._lookahead_peaks_dense(jnp.asarray(y), lookahead, delta)
    assert got == (dense[0], dense[1])
    assert len(got[0]) >= 5 and len(got[1]) >= 5      # the input fires


@pytest.mark.parametrize("seed,lookahead,delta,kind", [
    (6, 1, 0.0, "edges"), (7, 11, 0.1, "edges"), (8, 500, 0.0, 1000)])
def test_walk_matches_jax_pallas(seed, lookahead, delta, kind):
    """Against the Pallas kernel K2 ports, in interpret mode as
    tests/test_peaks_pallas.py runs it (one 1,024-sample grid step: the
    interpreter takes milliseconds a sample), exact."""
    n = 1024 + lookahead
    y = _input(kind, n, seed)
    got = peaks.lookahead_peaks(torch.from_numpy(y), lookahead, delta)
    with pltpu.force_tpu_interpret_mode():
        flat = np.asarray(jpeaks._lookahead_events_pallas(
            jnp.asarray(y), lookahead, delta, n - lookahead))
    want = jpeaks.unpack_lookahead_events(flat, lookahead, n, n - lookahead)
    assert got == (want[0], want[1])
    assert len(got[0]) + len(got[1]) >= 1


@pytest.mark.parametrize("y,lookahead", [
    (np.ones(5, np.float32), 5),                        # n == lookahead
    (np.ones(3, np.float32), 7),                        # n < lookahead
    (np.arange(200, dtype=np.float32), 4),              # ramp: no fire
    (np.float32([0, 3, 0, 0, 1, 1, 1, 1, 1, 1, 4, 0, 0, 0, 0, 0]), 3),  # max popped
    (np.float32([5, 1, 5, 5, 4, 4, 4, 4, 4, 4, 0, 5, 5, 5, 5, 5]), 3),  # min popped
    (np.float32([0, 3, 0, 0, 0, 0, 0, 0]), 3),          # the only event is popped
])
def test_walk_edge_cases_match_jax(y, lookahead):
    got = peaks.lookahead_peaks(torch.from_numpy(y), lookahead)
    want = jpeaks.lookahead_peaks(jnp.asarray(y), lookahead)
    assert got == (want[0], want[1])
    if len(y) == 16:           # three events, the first of them popped
        assert len(got[0]) == len(got[1]) == 1


def test_walk_event_buffer_bound():
    """The densest walk (a fire every other sample) stays inside the
    limit // 2 + 2 events the kernel's buffer holds, and equals JAX."""
    y = np.tile(np.float32([1, 0, 0, 1]), 1500)
    limit = len(y) - 1
    ev = peaks.lookahead_events(torch.from_numpy(y), 1)
    assert limit // 2 - 2 <= len(ev[0]) <= limit // 2 + 2
    assert torch.all(ev[0][1:] - ev[0][:-1] >= 2)
    got = peaks.lookahead_peaks(torch.from_numpy(y), 1)
    want = jpeaks._lookahead_peaks_dense(jnp.asarray(y), 1, 0.0)
    assert got == (want[0], want[1])


def test_forward_window_extrema_match_jax():
    y = _stress_y(3000, 7) + np.random.default_rng(7).standard_normal(3000).astype(np.float32)
    for w in (1, 11, 500):
        mx, mn = peaks.forward_window_extrema(torch.from_numpy(y), w)
        jmx, jmn = jpeaks._forward_window_extrema(jnp.asarray(y), w)
        assert np.array_equal(mx.numpy(), np.asarray(jmx))
        assert np.array_equal(mn.numpy(), np.asarray(jmn))


@pytest.mark.parametrize("bad", ["dtype", "length", "delta", "nan_delta",
                                 "device", "lookahead"])
def test_walk_rejects_bad_arguments(bad):
    y = torch.from_numpy(_stress_y(100, 0))
    fmax, fmin = y.clone(), y.clone()
    delta = 0.0
    if bad == "dtype":
        y = y.double()
    elif bad == "length":
        fmax = fmax[:-1]
    elif bad == "delta":
        delta = -0.1
    elif bad == "nan_delta":
        delta = float("nan")
    elif bad == "device":
        y, fmax, fmin = (t.to("meta") for t in (y, fmax, fmin))
    if bad == "lookahead":
        with pytest.raises(ValueError):
            peaks.lookahead_peaks(y, 0)
        return
    with pytest.raises(ValueError):
        peaks.lookahead_walk(y, fmax, fmin, delta)


# ----------------------------------------------------------------- convolutions, CRC, bits

@pytest.mark.parametrize("k", [18, 17, 5, 1])
def test_same_mode_convolutions_match_jax(k):
    rng = np.random.default_rng(k)
    x = rng.integers(-1, 2, 3000).astype(np.float32)
    w = rng.integers(-1, 2, k).astype(np.float32)
    for ours, theirs in ((fir.correlate_same, jfir.correlate_same),
                         (fir.convolve_same, jfir.convolve_same)):
        got = ours(torch.from_numpy(x), torch.from_numpy(w)).numpy()
        want = np.asarray(theirs(jnp.asarray(x), jnp.asarray(w)))
        assert np.array_equal(got, want)


def test_crc_equals_jax():
    rng = np.random.default_rng(3)
    for n in (0, 7, 16, 37, 120, 512, 2049):
        bits = "".join(str(b) for b in rng.integers(0, 2, n))
        assert crc.fcs_crc16_bits(bits) == jcrc.fcs_crc16_bits(bits)
        assert crc.fcs_crc16_bits([int(b) for b in bits]) == crc.fcs_crc16_bits(bits)


def test_bit_layer_equals_jax():
    J = jafsk.Afsk1200Decoder
    rng = np.random.default_rng(8)
    for n in (0, 1, 9, 300, 5000):
        bits = rng.integers(0, 2, n)
        bits[n // 3: n // 3 + 7] = 1                    # a run that stuffs
        assert np.array_equal(Afsk1200Decoder.find_bit_stuffing(bits),
                              J.find_bit_stuffing(bits))
        assert np.array_equal(Afsk1200Decoder.find_flags(bits), J.find_flags(bits))
        marks = J.find_bit_stuffing(bits)
        assert Afsk1200Decoder.reduce_stuffed_bit(bits, marks) == \
            J.reduce_stuffed_bit(bits, marks)
        if n:
            nrzi = np.sign(rng.standard_normal(n))
            assert np.array_equal(Afsk1200Decoder.decode_nrzi(nrzi), J.decode_nrzi(nrzi))
    msg = make_ax25_frame(info="port parity")[:-16]
    assert Afsk1200Decoder.parse_ax25(msg).__dict__ == J.parse_ax25(msg).__dict__


# ----------------------------------------------------------------- framing against the per-bit loop

def oracle_frames(nrzi) -> tuple[list, dict]:
    """The decoder's framing as one segment at a time, one bit at a time
    (the port's loop before the whole-stream version), over the JAX
    package's bit layer, CRC and parse: (frames, counts)."""
    J = jafsk.Afsk1200Decoder
    if len(nrzi) == 0:
        return [], {}
    bits = J.decode_nrzi(nrzi)
    stuffed = J.find_bit_stuffing(bits)
    flags = J.find_flags(bits)
    frames, checked = [], 0
    for fi in range(len(flags) - 1):
        seg = J.reduce_stuffed_bit(bits[flags[fi] + 8: flags[fi + 1]],
                                   stuffed[flags[fi] + 8: flags[fi + 1]])
        msg = seg[:-16]
        if len(seg) % 8 == 0 and len(msg) > 16 * 8:
            checked += 1
            sent = "".join(str(int(b)) for b in msg)
            got = "".join(str(int(b)) for b in seg[-16:])
            if jcrc.fcs_crc16_bits(sent) == got:
                frame = J.parse_ax25(msg)
                frame.start_bit = int(flags[fi])
                frames.append(frame)
    return frames, {"afsk.framing.bauds": len(nrzi), "afsk.framing.flags": len(flags),
                    "afsk.framing.crc_checks": checked,
                    "afsk.framing.frames": len(frames)}


def _nrzi(bits) -> np.ndarray:
    """NRZI levels (+/-1) whose decode is `bits` after the first (a 0
    flips the level)."""
    flips = np.cumsum(1 - np.asarray(bits, np.int64)[1:]) % 2
    return np.concatenate([[1.0], 1.0 - 2.0 * flips])


def _with_fcs(data: bytes) -> list:
    """Wire bits of `data` and its FCS, unstuffed."""
    bits = [(byte >> i) & 1 for byte in data for i in range(8)]
    return bits + [int(c) for c in crc.fcs_crc16_bits(bits)]


def _noise(rng, n) -> list:
    return [int(b) for b in rng.integers(0, 2, n)]


def _stream(case, rng) -> tuple[list, int]:
    """Wire bits of one case and the frames the oracle finds in it."""
    if case == "planted":                   # '~' and DEL stuff inside frames
        infos = ["~~\x7f stuffed ~", "plain one", "\x7f\x7f\x7f\x7f"]
        wire = []
        for info in infos:
            wire += (_noise(rng, 200) + FLAGS * 2 + stuff_bits(make_ax25_frame(info=info))
                     + FLAGS * 3)
        return wire, 3
    if case == "adjacent_flags":            # back to back, and sharing a 0
        overlap = FLAGS + FLAGS[1:] + FLAGS[1:]
        return (FLAGS * 4 + overlap + stuff_bits(make_ax25_frame(info="between"))
                + overlap + FLAGS * 2), 1
    if case == "lengths":                   # 144 and 152 bits, not whole bytes
        wire = list(FLAGS)
        for body in (bytes((rng.integers(0, 128, 16) * 2).tolist()),  # 144 bits
                     bytes((rng.integers(0, 128, 17) * 2).tolist())):  # 152
            wire += stuff_bits(_with_fcs(body)) + FLAGS
        wire += stuff_bits(_noise(rng, 150)) + FLAGS
        wire += stuff_bits(make_ax25_frame(info="x")[:-3]) + FLAGS
        return wire, 1
    if case == "noise":                     # flags by chance, one forced CRC
        forced = stuff_bits(_with_fcs(bytes(rng.integers(0, 256, 40).tolist())))
        return _noise(rng, 6000) + FLAGS + forced + FLAGS + _noise(rng, 6000), 1
    if case == "ends_mid_frame":
        frame = stuff_bits(make_ax25_frame(info="cut short"))
        return (FLAGS * 2 + stuff_bits(make_ax25_frame(info="whole")) + FLAGS * 2
                + frame[:len(frame) // 2]), 1
    raise ValueError(case)


@pytest.mark.parametrize("case", ["planted", "adjacent_flags", "lengths", "noise",
                                  "ends_mid_frame", 0, 1, 5, 7])
@pytest.mark.parametrize("seed", [0, 1])
def test_framing_equals_per_bit_oracle(case, seed, monkeypatch):
    """The whole-stream framing against the per-bit loop: the same frames
    (field for field, in order, with the same start bits) and the same
    four counters, from one CRC pass (`crc.fcs_crc16_check`) over every
    checked segment, none for an empty stream."""
    rng = np.random.default_rng([seed, len(str(case))])
    if isinstance(case, int):               # 0 and fewer than 8 bauds
        nrzi, found = np.sign(rng.standard_normal(case)), 0
    else:
        wire, found = _stream(case, rng)
        nrzi = _nrzi([1] + wire)
    want, counts = oracle_frames(nrzi)
    dec = Afsk1200Decoder(ArraySource(np.zeros(10, np.complex64), FS), OFF,
                          device="cpu")
    passes = []
    check = crc.fcs_crc16_check

    def counting(data, seg_counts):
        passes.append(len(seg_counts))
        return check(data, seg_counts)

    monkeypatch.setattr(crc, "fcs_crc16_check", counting)
    got = dec._frames_from_nrzi(nrzi)
    assert [f.__dict__ for f in got] == [f.__dict__ for f in want]
    assert len(want) == found and dec.useful == int(found > 0)
    assert dec.counters == counts
    assert passes == ([counts.get("afsk.framing.crc_checks", 0)] if len(nrzi) else [])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batched_crc_equals_per_segment(seed):
    """`crc.fcs_crc16_check` over byte-aligned segments of 0, 1, 2, 17 and
    300 bytes, some with their FCS right, in one batch and one at a time,
    against the string check of `fcs_crc16_bits` and the JAX package's."""
    rng = np.random.default_rng(seed)
    segs = []
    for nbytes in (0, 1, 2, 17, 300, 2, 17, 300, 17):
        data = rng.integers(0, 256, nbytes).astype(np.uint8)
        if nbytes >= 2 and rng.random() < 0.6:
            bits = np.unpackbits(data[:-2], bitorder="little")
            fcs = int(crc.fcs_crc16_bits(bits)[::-1], 2)
            data[-2:] = [fcs & 0xFF, fcs >> 8]
        segs.append(data)
    segs[2][:] = 0                           # the FCS of no bytes
    want = []
    for data in segs:
        s = "".join(str(b) for b in np.unpackbits(data, bitorder="little"))
        ours = len(s) >= 16 and crc.fcs_crc16_bits(s[:-16]) == s[-16:]
        theirs = len(s) >= 16 and jcrc.fcs_crc16_bits(s[:-16]) == s[-16:]
        assert ours == theirs
        want.append(ours)
    counts = [len(d) for d in segs]
    got = crc.fcs_crc16_check(np.concatenate(segs), counts)
    assert got.tolist() == want and want[2] and not all(want)
    assert [bool(crc.fcs_crc16_check(d, [len(d)])[0]) for d in segs] == want
    assert crc.fcs_crc16_check(np.zeros(0, np.uint8), []).tolist() == []


@pytest.mark.parametrize("msg", [
    make_ax25_frame(info="port parity")[:-16],
    make_ax25_frame(info="\x7f~ all 256: \xff")[:-16],
    [0, 1, 0, 0, 0, 0, 1, 0] * 20,          # no byte ends the header
    [1] * 8 + [0, 0, 0, 0, 0, 1, 1, 0],     # the header is one byte
    make_ax25_frame(info="")[:-16][:-5],    # a trailing partial byte
    [],
])
def test_parse_ax25_equals_jax(msg):
    assert Afsk1200Decoder.parse_ax25(msg).__dict__ == \
        jafsk.Afsk1200Decoder.parse_ax25(msg).__dict__
    assert Afsk1200Decoder.parse_ax25(np.asarray(msg, bool)).__dict__ == \
        Afsk1200Decoder.parse_ax25(msg).__dict__


def test_window_means_match_jax():
    rng = np.random.default_rng(12)
    bf = rng.standard_normal(40_000).astype(np.float32)
    spb = constants.AFSK_DEFAULT_BW // constants.AFSK_BAUDRATE
    starts = np.concatenate([np.sort(rng.integers(0, 39_000, 500)),
                             [40_000 - 5, 40_000, 40_003]])   # partial, empty
    got = _window_means(torch.from_numpy(bf), torch.from_numpy(starts), spb).numpy()
    hl = np.stack([(starts // 4096).astype(np.float32),
                   (starts % 4096).astype(np.float32)])
    want = np.asarray(jafsk._window_means(jnp.asarray(bf), jnp.asarray(hl), spb))
    assert np.max(np.abs(got - want)) < 1e-6 * np.max(np.abs(bf))
    assert got[-2] == got[-1] == 0.0


# ----------------------------------------------------------------- front end and decoder

def _wire(infos):
    wire = FLAGS * 3
    for info in infos:
        wire += stuff_bits(make_ax25_frame(info=info)) + FLAGS * 3
    return wire


def _capture(infos, seed=1):
    iq = afsk_modulate(_wire(infos), FS, offset_hz=OFF)
    rng = np.random.default_rng(seed)
    return iq + 0.02 * (rng.standard_normal(len(iq))
                        + 1j * rng.standard_normal(len(iq))).astype(np.complex64)


def _quantize(iq):
    raw = np.empty(2 * len(iq), np.uint8)
    raw[0::2] = np.clip(np.round(iq.real * 100 + 127.5), 0, 255)
    raw[1::2] = np.clip(np.round(iq.imag * 100 + 127.5), 0, 255)
    return raw


@pytest.fixture(scope="module")
def aprs_capture():
    """The capture of tests/test_afsk1200.py, plus its 8-bit quantization."""
    iq = _capture(["hello tpu world!"])
    return iq, _quantize(iq)


def _key(frames):
    return [(f.info, f.source, f.destination, f.path, f.control, f.protocol,
             f.start_bit) for f in frames]


def test_designed_constants_equal_jax():
    dec = Afsk1200Decoder(ArraySource(np.zeros(10, np.complex64), FS), OFF,
                          device="cpu")
    fe = dec._frontend()
    jfe = JDdcFm(FS, OFF, jdesign.blackmanharris(151), constants.AFSK_DEFAULT_BW,
                 fm=False)
    assert fe.stride == jfe.stride == 92 and fe.out_rate == jfe.out_rate
    assert np.array_equal(fe.taps_mod, jfe.taps_mod) and fe.rot == complex(jfe.rot)
    jbp = jiir.IirFilter.design_butter(fe.out_rate, 700, 2700, order=6,
                                       kind="bandpass")
    bp = dec._bandpass(fe.out_rate)
    assert np.array_equal(bp.sos, np.asarray(jbp.sos))
    assert np.array_equal(bp.initial_state_step(torch.float64).numpy(),
                          np.asarray(jbp.initial_state_step(jnp.float64)))


def _hide_device_bytes(monkeypatch):
    """The decoder's test of where the bytes lie answers "not on the
    device": it takes the block plan over the same source (the feed still
    slices the blocks out of the held bytes)."""
    monkeypatch.setattr(afsk_mod, "device_bytes", lambda src, device=None: None)


def test_fm_audio_matches_jax_resident_complex(aprs_capture, monkeypatch):
    """The port's FM front end (block 0 shortened so K1's plain version
    runs over the rest) against the JAX complex front end discriminated over
    the whole stream, on the resident and on the blocked path."""
    _, raw = aprs_capture
    n = len(raw) // 2
    monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 200_000)
    jfe = JDdcFm(FS, OFF, jdesign.blackmanharris(151), constants.AFSK_DEFAULT_BW,
                 fm=False)
    c = np.asarray(jfe.resident_complex(jnp.asarray(raw), n)).astype(np.complex64)
    ref = np.angle(c[1:] * np.conj(c[:-1]) * np.complex64(jfe.rot))
    src = DeviceRawSource(torch.from_numpy(raw), FS)
    for resident in (True, False):
        dec = Afsk1200Decoder(src, OFF, device="cpu")
        if not resident:
            _hide_device_bytes(monkeypatch)
        got, rate = dec._baseband_audio()
        assert rate == jfe.out_rate
        got = got.numpy()
        assert got.shape == ref.shape
        d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - ref))))
        assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2


def test_decoder_matches_jax_on_complex_source(aprs_capture):
    iq, _ = aprs_capture
    dec = Afsk1200Decoder(ArraySource(iq, FS), OFF, device="cpu")
    jdec = jafsk.Afsk1200Decoder(JArraySource(iq, FS), OFF)
    frames = dec.get_frames()
    assert _key(frames) == _key(jdec.get_frames())
    assert frames[-1].info == "hello tpu world!" and dec.useful == jdec.useful == 1
    assert dec.get_msg() == jdec.get_msg() == "hello tpu world!"
    assert set(dec.stage_seconds) == {"fm_frontend", "bit_sync", "framing"}


def test_decoder_matches_jax_on_raw_bytes(aprs_capture, tmp_path, monkeypatch):
    """The quantized capture held in a CPU DeviceRawSource, block 0
    shortened so the resident front end runs K1's plain version, against the
    JAX decoder on the same bytes from a file."""
    _, raw = aprs_capture
    p = tmp_path / "aprs.dat"
    raw.tofile(p)
    monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 200_000)
    before = ddc.LAUNCHES, peaks.LAUNCHES
    dec = Afsk1200Decoder(DeviceRawSource(torch.from_numpy(raw), FS), OFF,
                          device="cpu")
    jdec = jafsk.Afsk1200Decoder(JIQDat(str(p), FS), OFF)
    assert _key(dec.get_frames()) == _key(jdec.get_frames())
    assert dec.useful == jdec.useful == 1 and dec.device.type == "cpu"
    assert (ddc.LAUNCHES, peaks.LAUNCHES) == before   # the CPU launches nothing


def test_resident_path_matches_blocked_path(monkeypatch):
    """Three frames: the bytes held in a DeviceRawSource through the
    resident front end equal the blocked stream of the same bytes, frame
    for frame (mirrors tests/test_afsk1200.py::test_fused_path_matches_legacy)."""
    infos = ["first frame", "second frame!", "third and last frame"]
    raw = _quantize(_capture(infos, seed=4))
    monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 300_000)
    src = DeviceRawSource(torch.from_numpy(raw), FS)
    d1 = Afsk1200Decoder(src, OFF, device="cpu")
    f1 = d1.get_frames()
    _hide_device_bytes(monkeypatch)
    d2 = Afsk1200Decoder(src, OFF, device="cpu")
    f2 = d2.get_frames()
    assert [f.info for f in f1] == infos
    assert _key(f1) == _key(f2) and d1.useful == d2.useful == 1


def test_noise_only_capture_is_not_useful():
    rng = np.random.default_rng(9)
    n = 400_000
    iq = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    dec = Afsk1200Decoder(ArraySource(iq, FS), OFF, device="cpu")
    assert dec.get_frames() == [] and dec.useful == 0 and dec.get_msg() is None


def test_chip_smoke_synthesizer_decodes():
    """chip_smoke.py's torch APRS synthesizer (what the card decodes at
    full size), at 3 s on the CPU: every planted frame comes back."""
    raw, infos = chip_smoke.synth_aprs_bytes(3.0, "cpu", seed=3)
    assert raw.dtype == torch.uint8 and raw.shape[0] == 2 * 3 * FS
    assert len(infos) >= 4 and all(len(i) == 30 for i in infos)
    dec = Afsk1200Decoder(DeviceRawSource(raw, FS), chip_smoke.APRS_OFFSET_HZ,
                          device="cpu")
    assert [f.info for f in dec.get_frames()] == infos
