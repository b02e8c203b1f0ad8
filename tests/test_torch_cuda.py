"""The port on a CUDA card: K1, K2, K3 and K4 against their plain versions,
and the card's front ends (raw and complex, one channel and a bank), the FM
decoder, the stream API and the NOAA, AFSK, Funcube and Meteor decodes
against the same code on the CPU.

Every test here needs a card and skips without one. The file imports no
jax, so on a machine without jax it runs alone:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: K1 and K4 and their plain versions are all fp32 and sum in
different orders, so wrapped phase differences are held to the JAX suite's
bars for fp32 phase outputs (99.9th percentile < 1e-4, max < 2e-2), and K4
to the fp64 oracle within 2e-4 rad (so are K1 and K4 where they stage
their span in passes); each output's arithmetic does not depend on the
launch, so a channel of a bank must equal the one-channel launch, and a
launch that reads a history through `head=` the launch over the
concatenated samples, bit for bit; K2 and its plain
version compare the same float32 values, so their events must be equal
(so must peaks_fft's walk at lookahead 500; peaks_fft on the card and the
CPU to the CPU parity bars, 1e-3 in x and 1e-6 in value; the B-spline
prefilter to scipy's cspline1d within 1e-9);
decodes on the card and on the CPU to the bars of tests/test_torch_noaa.py
(equal crude syncs, image within one uint8 level on under 1 % of pixels,
accurate syncs within +/-1 sample), and AFSK decodes frame for frame. K3
and its plain version take the same float32 operations (cos and sin from
the double-precision functions on both sides), so symbol indices, minsync
flags and needle choices must be equal and phases agree to 1e-6 rad (the
tests of the stage split, segments over blocks and the carried state hold
state rows and phases equal bit for bit); PSK
decodes on the card and the CPU must give the same syncs within 2 samples
(their low-pass filters sum in another order), Meteor's from its second
reported sync on; pass 2 on the card and on the CPU over the same filtered
blocks and symbols must give the same syncs (both correlate whole numbers
and round, so only a quantized entry that truncates the other way, where
the card's complex64 rotation differs in its last bit, could move one)."""
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (FS, APRS_OFFSET_HZ, FC_OFFSET_HZ,  # noqa: E402
                        MM_OFFSET_HZ, k3_streams, stress_edges,
                        synth_aprs_bytes, synth_funcube_bytes,
                        synth_meteor_bytes, synth_pass_bytes)
from directdemod_tpu_torch import constants  # noqa: E402
from directdemod_tpu_torch.io import sources  # noqa: E402
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder  # noqa: E402
from directdemod_tpu_torch.models.frontend import DdcFm, DdcFmStream  # noqa: E402
from directdemod_tpu_torch.models.noaa import NoaaDecoder  # noqa: E402
from directdemod_tpu_torch.models.funcube import FuncubeDecoder  # noqa: E402
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder  # noqa: E402
from directdemod_tpu_torch.models import psk_sync  # noqa: E402
from directdemod_tpu_torch.ops import ddc, design, peaks, pll  # noqa: E402

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _fe(bw=60000):
    return DdcFm(FS, 30000, design.blackmanharris(151), bw)


def _phase_close(a, b):
    d = np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b)))))
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2, (
        np.percentile(d, 99.9), d.max())


@pytest.mark.parametrize("bw", [60000, 22050, 5000])   # J = 34, 92, 409
@pytest.mark.parametrize("out_len", [1, 127, 128, 129, 5000, 100_003])
def test_kernel_matches_plain(dev, out_len, bw):
    fe = _fe(bw)
    j, k = fe.stride, fe.ntaps
    rng = np.random.default_rng(out_len)
    raw = torch.from_numpy(rng.integers(0, 256, 2 * ((out_len - 1) * j + k))
                           .astype(np.uint8)).to(dev)
    _, taps_rev, rot, _ = fe.consts(dev)
    cp = torch.tensor([1 + 0.5j], dtype=torch.complex64, device=dev)
    before = ddc.LAUNCHES
    a_k, c_k = ddc.ddc_fm_u8(raw, taps_rev, rot, cp, j, out_len)
    a_p, c_p = ddc.ddc_fm_u8_plain(raw, taps_rev, rot, cp, j, out_len)
    torch.cuda.synchronize()
    assert ddc.LAUNCHES == before + 1
    assert a_k.shape == (out_len,) and a_k.device == raw.device
    _phase_close(a_k.cpu(), a_p.cpu())
    assert abs(complex((c_k - c_p).cpu()[0])) < 1e-5 * abs(complex(c_p.cpu()[0])) + 1e-2


def test_kernel_rejects_mixed_devices(dev):
    fe = _fe()
    j, k = fe.stride, fe.ntaps
    raw = torch.zeros(2 * (9 * j + k), dtype=torch.uint8, device=dev)
    _, taps_rev, rot, _ = fe.consts("cpu")
    cp = torch.zeros(1, dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError):
        ddc.ddc_fm_u8(raw, taps_rev, rot.to(dev), cp, j, 10)


def _bank(bw, freqs=(30000,)):
    """(C, K) reversed taps, rot and c_prev on the card for `freqs`."""
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    m = MultiDdcFm(FS, freqs, design.blackmanharris(151), bw)
    _, taps_rev, rot, _ = m.consts("cuda")
    cp = torch.tensor([1 + 0.5j] * len(freqs), dtype=torch.complex64, device="cuda")
    return m, taps_rev, rot, cp


def _oracle(x, taps_rev, rot, cp, j, out_len):
    """fp64 windows and discriminator of one channel (host)."""
    w = taps_rev.cpu().numpy().astype(np.complex128)
    xx = x.cpu().numpy().astype(np.complex128)
    win = np.lib.stride_tricks.sliding_window_view(xx, len(w))[::j][:out_len]
    c = win @ w
    prev = np.concatenate([[complex(cp.cpu()[0])], c[:-1]])
    return np.angle(c * np.conj(prev) * complex(rot.cpu()[0])), c


@pytest.mark.parametrize("bw", [60000, 30000, 5000])    # J = 34, 68, 409
@pytest.mark.parametrize("out_len", [1, 127, 128, 129, 5000, 100_003])
def test_k4_matches_plain_and_oracle(dev, out_len, bw):
    """K4 against its plain version (fp32 bars) and the fp64 oracle
    (< 2e-4 rad); c_last is c[out_len-1] at any out_len."""
    m, taps_rev, rot, cp = _bank(bw)
    j, k = m.stride, m.ntaps
    n = (out_len - 1) * j + k
    rng = np.random.default_rng(out_len + bw)
    x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                         .astype(np.complex64)).to(dev)
    before = ddc.LAUNCHES_C64
    a_k, c_k = ddc.ddc_fm_c64(x, taps_rev, rot, cp, j, out_len)
    a_p, c_p = ddc.ddc_fm_c64_plain(x, taps_rev, rot, cp, j, out_len)
    torch.cuda.synchronize()
    assert ddc.LAUNCHES_C64 == before + 1
    assert a_k.shape == (1, out_len) and c_k.shape == (1,)
    _phase_close(a_k.cpu(), a_p.cpu())
    ref, c = _oracle(x, taps_rev[0], rot, cp, j, out_len)
    d = np.abs(np.angle(np.exp(1j * (a_k[0].cpu().numpy() - ref))))
    assert d.max() < 2e-4
    assert abs(complex(c_k.cpu()[0]) - c[-1]) < 5e-6 * np.abs(c).max()


@pytest.mark.parametrize("kind", ["u8", "c64"])
def test_channel_axis_equals_single_channels_bit_for_bit(dev, kind):
    """Three channels in one launch: each channel's outputs equal the
    one-channel launch at its offset bit for bit (the channel loop keeps
    each output's arithmetic)."""
    freqs = (120_000, 412_500, -400_000)
    m, taps_rev, rot, cp = _bank(60000, freqs)
    j, k, out_len = m.stride, m.ntaps, 70_001
    n = (out_len - 1) * j + k
    rng = np.random.default_rng(3)
    if kind == "u8":
        x = torch.from_numpy(rng.integers(0, 256, 2 * n).astype(np.uint8)).to(dev)
        fn = ddc.ddc_fm_u8
    else:
        x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                             .astype(np.complex64)).to(dev)
        fn = ddc.ddc_fm_c64
    audio, c_last = fn(x, taps_rev, rot, cp, j, out_len)
    assert audio.shape == (3, out_len)
    for ch in range(3):
        a1, c1 = fn(x, taps_rev[ch].contiguous(), rot[ch:ch + 1].contiguous(),
                    cp[ch:ch + 1].contiguous(), j, out_len)
        assert torch.equal(audio[ch], a1) and torch.equal(c_last[ch:ch + 1], c1)


def _bank_input(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        return (torch.from_numpy(rng.integers(0, 256, 2 * n).astype(np.uint8))
                .to("cuda"), ddc.ddc_fm_u8, ddc.ddc_fm_u8_plain)
    return (torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                             .astype(np.complex64)).to("cuda"),
            ddc.ddc_fm_c64, ddc.ddc_fm_c64_plain)


def _as_samples(kind, x):
    if kind == "u8":
        r = x.cpu().numpy().astype(np.float64) - 127.5
        return torch.from_numpy(r[0::2] + 1j * r[1::2])
    return x


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("out_len", [1, 31, 32, 5000])
def test_staging_in_passes_matches_plain_and_oracle(dev, kind, out_len):
    """J = 1,024 (a 2 kHz `-b`): even at T = 32 the span of a block does not
    fit the shared memory, so the kernels stage it in passes; two channels,
    each against the plain version (fp32 bars) and the fp64 oracle."""
    m, taps_rev, rot, cp = _bank(2000, (30000, -70000))
    j, k = m.stride, m.ntaps
    assert j == 1024
    n = (out_len - 1) * j + k
    x, fn, plain = _bank_input(kind, n, out_len)
    a_k, c_k = fn(x, taps_rev, rot, cp, j, out_len)
    a_p, _ = plain(x, taps_rev, rot, cp, j, out_len)
    torch.cuda.synchronize()
    _phase_close(a_k.cpu(), a_p.cpu())
    xs = _as_samples(kind, x)
    for ch in range(2):
        ref, c = _oracle(xs, taps_rev[ch], rot[ch:ch + 1], cp[ch:ch + 1], j, out_len)
        d = np.abs(np.angle(np.exp(1j * (a_k[ch].cpu().numpy() - ref))))
        assert d.max() < 2e-4
        assert abs(complex(c_k.cpu()[ch]) - c[-1]) < 5e-6 * np.abs(c).max()


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("n_head", [1, 150])
def test_kernel_reads_a_head_in_place(dev, kind, n_head):
    """[head | x] through two pointers equals the launch over the
    concatenated samples bit for bit."""
    m, taps_rev, rot, cp = _bank(60000, (30000, -70000))
    j, k, out_len = m.stride, m.ntaps, 20_011
    n = (out_len - 1) * j + k
    x, fn, _ = _bank_input(kind, n, n_head)
    cut = n_head * (2 if kind == "u8" else 1)
    whole = fn(x, taps_rev, rot, cp, j, out_len)
    split = fn(x[cut:].clone(), taps_rev, rot, cp, j, out_len, head=x[:cut].clone())
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[1], split[1])


def _tile_model():
    """tests/test_torch_tile_model.py, the CPU model of the tile's plan."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "tile_model", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "test_torch_tile_model.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bank_j(j, freqs=(30000,)):
    """`_bank` at the bandwidth whose stride is j."""
    m, taps_rev, rot, cp = _bank(FS / (j + 0.5), freqs)
    assert m.stride == j
    return m, taps_rev, rot, cp


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("j", [33, 34, 68, 92, 409, 1022, 1023])
def test_tile_layouts_match_plain_and_oracle(dev, kind, j):
    """Odd J stages packed, even J skewed (a pad after every J samples and a
    zero tap at each); above J ~935 both in passes (of whole rows when
    skewed): every layout against the plain version (fp32 bars) and the
    fp64 oracle (< 2e-4 rad), on two channels and a ragged out_len; the plan
    the kernel reports is the one `tests/test_torch_tile_model.py` models."""
    m, taps_rev, rot, cp = _bank_j(j, (30000, -70000))
    k, out_len = m.ntaps, 3001
    plan = ddc.launch_plan("ddc_fm_" + kind, 2, k, j, out_len)
    props = torch.cuda.get_device_properties(0)
    model = _tile_model()
    assert tuple(plan[f] for f in ("T", "S", "skew", "L", "smem", "passes")) == \
        model.tile_plan(2, k, j, out_len, props.shared_memory_per_block_optin)
    tiles = -(-out_len // (plan["T"] - 1))
    assert plan["grid"] == min(tiles, plan["blocks_per_sm"] * props.multi_processor_count)
    assert plan["skew"] == (j % 2 == 0) and plan["blocks_per_sm"] >= 1
    assert (plan["passes"] > 1) == (j > 1000)
    x, fn, plain = _bank_input(kind, (out_len - 1) * j + k, j)
    a_k, c_k = fn(x, taps_rev, rot, cp, j, out_len)
    a_p, _ = plain(x, taps_rev, rot, cp, j, out_len)
    torch.cuda.synchronize()
    _phase_close(a_k.cpu(), a_p.cpu())
    xs = _as_samples(kind, x)
    for ch in range(2):
        ref, c = _oracle(xs, taps_rev[ch], rot[ch:ch + 1], cp[ch:ch + 1], j, out_len)
        d = np.abs(np.angle(np.exp(1j * (a_k[ch].cpu().numpy() - ref))))
        assert d.max() < 2e-4
        assert abs(complex(c_k.cpu()[ch]) - c[-1]) < 5e-6 * np.abs(c).max()


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("j", [34, 68, 92])
def test_persistent_grid_over_ragged_tiles(dev, kind, j):
    """A grid smaller than the tile count (each block walks several tiles)
    and an out_len that is not a whole number of tiles: against the plain
    version and the fp64 oracle, c_last included, and bit for bit with the
    history read in place."""
    m, taps_rev, rot, cp = _bank_j(j, (30000, -70000))
    k, out_len = m.ntaps, 200_003
    plan = ddc.launch_plan("ddc_fm_" + kind, 2, k, j, out_len)
    assert plan["grid"] < -(-out_len // (plan["T"] - 1)) and out_len % (plan["T"] - 1)
    x, fn, plain = _bank_input(kind, (out_len - 1) * j + k, 7 * j)
    a_k, c_k = fn(x, taps_rev, rot, cp, j, out_len)
    a_p, _ = plain(x, taps_rev, rot, cp, j, out_len)
    cut = 150 * (2 if kind == "u8" else 1)
    split = fn(x[cut:].clone(), taps_rev, rot, cp, j, out_len, head=x[:cut].clone())
    torch.cuda.synchronize()
    assert torch.equal(a_k, split[0]) and torch.equal(c_k, split[1])
    _phase_close(a_k.cpu(), a_p.cpu())
    xs = _as_samples(kind, x)
    for ch in range(2):
        ref, c = _oracle(xs, taps_rev[ch], rot[ch:ch + 1], cp[ch:ch + 1], j, out_len)
        d = np.abs(np.angle(np.exp(1j * (a_k[ch].cpu().numpy() - ref))))
        assert d.max() < 2e-4
        assert abs(complex(c_k.cpu()[ch]) - c[-1]) < 5e-6 * np.abs(c).max()


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4, 5])
def test_each_channel_count_equals_single_channels_bit_for_bit(dev, kind, channels):
    """C <= 4 keeps the channels' sums in registers inside the tap loop, C = 5
    loops over the channels outside it: either way each channel equals its
    one-channel launch bit for bit, skewed (J = 34) and packed (J = 33)."""
    freqs = (120_000, 412_500, -400_000, 30000, -70000)[:channels]
    for j in (34, 33):
        m, taps_rev, rot, cp = _bank_j(j, freqs)
        out_len = 20_011
        x, fn, _ = _bank_input(kind, (out_len - 1) * j + m.ntaps, channels)
        audio, c_last = fn(x, taps_rev, rot, cp, j, out_len)
        assert audio.shape == (channels, out_len)
        for ch in range(channels):
            a1, c1 = fn(x, taps_rev[ch].contiguous(), rot[ch:ch + 1].contiguous(),
                        cp[ch:ch + 1].contiguous(), j, out_len)
            assert torch.equal(audio[ch], a1) and torch.equal(c_last[ch:ch + 1], c1)


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("j", [68, 92, 1024])
def test_skewed_kernel_reads_a_head_in_place(dev, kind, j):
    """At even J, one pass and in passes: [head | x] through two pointers
    equals the launch over the concatenated samples bit for bit."""
    m, taps_rev, rot, cp = _bank_j(j, (30000, -70000))
    k, out_len, n_head = m.ntaps, 4001, 150
    x, fn, _ = _bank_input(kind, (out_len - 1) * j + k, j)
    cut = n_head * (2 if kind == "u8" else 1)
    whole = fn(x, taps_rev, rot, cp, j, out_len)
    split = fn(x[cut:].clone(), taps_rev, rot, cp, j, out_len, head=x[:cut].clone())
    assert torch.equal(whole[0], split[0]) and torch.equal(whole[1], split[1])


def test_complex_front_ends_on_the_card_match_cpu(dev):
    """FmDecoder, Stream.run_fused and a complex MultiDdcFm on the card: one
    K4 launch a block, and the CPU's outputs within the fp32 bars."""
    from directdemod_tpu_torch.models.fm import FmDecoder
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import filters
    from directdemod_tpu_torch.stream.api import Stream
    n = 1_300_017
    t = np.arange(n) / FS
    rng = np.random.default_rng(4)
    x = (90 * np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 700 * t)))
         + 2 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    src = sources.ArraySource(x, FS)
    blocks = 5
    out = {}
    for where in ("cuda", "cpu"):
        before = ddc.LAUNCHES_C64
        fm = FmDecoder(src, 30000, device=where)
        fm.get_audio()
        fused = (Stream(src, device=where).shift(30000)
                 .filter(filters.blackman_harris(151)).bw_limit(60000).fm_demod()
                 .run_fused(block_size=300_000))
        bank = MultiDdcFm(FS, (30000, -200_000), design.blackmanharris(151),
                          60000).process(src, block_size=300_000, device=where)
        out[where] = (fm._audio[0], fused[0], bank[0], ddc.LAUNCHES_C64 - before)
    assert out["cuda"][3] == 1 + 2 * blocks and out["cpu"][3] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=1e-4)
    for i in (1, 2):
        _phase_close(out["cuda"][i], out["cpu"][i])


def _walk_args(y, lookahead):
    limit = y.shape[0] - lookahead
    fmax, fmin = peaks.forward_window_extrema(y, lookahead)
    return y[:limit], fmax[:limit].contiguous(), fmin[:limit].contiguous()


@pytest.mark.parametrize("n,lookahead,delta", [
    (100_011, 11, 0.0), (100_011, 11, 0.1), (4096 + 11, 11, 0.0),
    (8193 + 11, 11, 0.0), (5000, 1, 0.0), (70_000, 500, 0.0), (12, 11, 0.0)])
def test_walk_kernel_matches_plain(dev, n, lookahead, delta):
    y = stress_edges(n, n, dev)
    args = _walk_args(y, lookahead)
    before = peaks.LAUNCHES
    got = peaks.lookahead_walk(*args, delta)
    want = peaks.lookahead_walk_plain(*args, delta)
    assert peaks.LAUNCHES == before + 1
    assert got[0].device == y.device and got[0].shape == want[0].shape
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("chunk", [1, 7, 1000, 4097, 65536, 10 ** 6])
def test_walk_kernel_chunks_match_plain(dev, chunk):
    """The chunk-speculative walk at chunk lengths from 1 to more than the
    walk, most of which do not divide it (limit 100,000)."""
    y = stress_edges(100_011, 17, dev)
    args = _walk_args(y, 11)
    stats = {}
    got = peaks.lookahead_walk(*args, 0.0, chunk=chunk, stats=stats)
    want = peaks.lookahead_walk_plain(*args, 0.0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    n_chunks = -(-100_000 // min(chunk, 100_000))
    assert stats["chunks"] == n_chunks == stats["stitch_steps"].shape[0]
    assert int(stats["stitch_steps"].max()) <= stats["chunk"]
    assert bool(stats["met"][0])


@pytest.mark.parametrize("chunk", [256, 16384])
def test_walk_kernel_on_afsk_edges(dev, chunk):
    """The AFSK decode's own edge strength (exact zeros between frames,
    where no walk fires and the stitch walks on)."""
    raw, _ = synth_aprs_bytes(8.0, dev, seed=4)
    edges = Afsk1200Decoder(sources.DeviceRawSource(raw, FS), APRS_OFFSET_HZ,
                            device=dev)._edges()[1]
    args = _walk_args(edges, 11)
    got = peaks.lookahead_walk(*args, 0.0, chunk=chunk)
    want = peaks.lookahead_walk_plain(*args, 0.0)
    assert got[0].shape[0] > 1000
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_walk_kernel_densest_walk(dev):
    """A fire every other sample fills the limit // 2 + 2 event buffer as
    far as any input can."""
    y = torch.tensor([1.0, 0.0, 0.0, 1.0] * 5000, device=dev)
    args = _walk_args(y, 1)
    got = peaks.lookahead_walk(*args, 0.0)
    want = peaks.lookahead_walk_plain(*args, 0.0)
    assert got[0].shape[0] >= args[0].shape[0] // 2 - 2
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_walk_kernel_rejects_bad_arguments(dev):
    y = stress_edges(1000, 0, dev)
    y_, fmax, fmin = _walk_args(y, 11)
    with pytest.raises(ValueError):                      # mixed devices
        peaks.lookahead_walk(y_, fmax.cpu(), fmin, 0.0)
    with pytest.raises(ValueError):                      # negative delta
        peaks.lookahead_walk(y_, fmax, fmin, -1.0)
    with pytest.raises(ValueError):                      # float64
        peaks.lookahead_walk(y_.double(), fmax.double(), fmin.double(), 0.0)


def test_walk_kernel_names_in_the_trace(dev):
    """A K2 launch shows in a `torch.profiler` trace as its three kernels,
    under names that hold `k2_` and no library kernel's name, and its
    events stay the plain walk's."""
    y = stress_edges(100_011, 17, dev)
    args = _walk_args(y, 11)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = peaks.lookahead_walk(*args, 0.0)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "memcpy" not in e.name.lower() and "memset" not in e.name.lower()}
    k2 = ("k2_speculative_walks", "k2_stitch", "k2_gather")
    assert len(names) == 3, names
    assert sorted(next(k for k in k2 if k in n) for n in names) == sorted(k2)
    for a, b in zip(got, peaks.lookahead_walk_plain(*args, 0.0)):
        assert torch.equal(a, b)


def _interpolated_tone(period: int, periods: int, dev):
    """A unit tone of `period` samples a period, 32x FFT-interpolated as
    peaks_fft interpolates it, float32 on `dev`."""
    from directdemod_tpu_torch.ops.peaks_extra import _fft_interp
    seg = torch.sin(2 * np.pi * torch.arange(period * periods, dtype=torch.float64,
                                             device=dev) / period)
    return _fft_interp(seg, 32 * period * periods).float()


@pytest.mark.parametrize("period,periods", [(32, 64), (2048, 8)])
def test_walk_kernel_at_lookahead_500_on_an_interpolated_tone(dev, period, periods):
    """peaks_fft's walk: lookahead 500 over 1,024 and 65,536 walk samples a
    period. At 65,536 four 16,384-sample chunks of each half-period hold no
    fire, so the stitch meets them by checkpoint alone."""
    y = _interpolated_tone(period, periods, dev)
    delta = 4 * float(np.sin(np.pi / period))            # peaks_fft's 2 max|dy|
    args = _walk_args(y, 500)
    stats = {}
    got = peaks.lookahead_walk(*args, delta, stats=stats)
    want = peaks.lookahead_walk_plain(*args, delta)
    assert got[0].shape[0] >= 2 * periods - 1            # one a half-period
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(stats["met"][1:].any())


def test_peaks_fft_on_the_card_matches_cpu(dev):
    """peaks_fft (K2 at lookahead 500, one launch a call) on the card
    against device="cpu": the same count, positions within 1e-3 in x units,
    values within 1e-6 (the CPU parity tests' bars)."""
    from directdemod_tpu_torch.ops import peaks_extra as px
    rng = np.random.default_rng(3)
    x = np.linspace(0.0, 1.0, 1 << 14, endpoint=False)
    y = np.sin(2 * np.pi * 64 * x + 1.0) + 0.01 * rng.standard_normal(x.size)
    before = peaks.LAUNCHES
    got = px.peaks_fft(y, x, device=dev)
    assert peaks.LAUNCHES == before + 1
    want = px.peaks_fft(y, x, device="cpu")
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        assert g.shape == w.shape and len(g) >= 60
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=0, atol=1e-3)
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n", [257, 1 << 20])
def test_cspline_coeffs_on_the_card_match_scipy(dev, n):
    from scipy.signal import cspline1d
    from directdemod_tpu_torch.ops import peaks_extra as px
    y = np.random.default_rng(n).standard_normal(n)
    got = px._cspline_coeffs(torch.from_numpy(y).to(dev))
    assert got.device == dev
    np.testing.assert_allclose(got.cpu().numpy(), cspline1d(y), rtol=0, atol=1e-9)


def test_afsk_decode_on_the_card_matches_cpu(dev, monkeypatch):
    """A 20 s APRS capture held on the card (the resident front end: one K1
    launch over the whole capture, block 0 included) decodes as on the CPU,
    frame for frame."""
    monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 4_000_000)
    raw, infos = synth_aprs_bytes(20.0, dev, seed=3)
    out = {}
    for where, data in (("cuda", raw), ("cpu", raw.cpu())):
        before = ddc.LAUNCHES, peaks.LAUNCHES
        dec = Afsk1200Decoder(sources.DeviceRawSource(data, FS), APRS_OFFSET_HZ,
                              device=where)
        frames = dec.get_frames()
        out[where] = ([(f.info, f.source, f.destination, f.start_bit)
                       for f in frames], dec.useful,
                      (ddc.LAUNCHES - before[0], peaks.LAUNCHES - before[1]))
    assert out["cuda"][2] == (1, 1) and out["cpu"][2] == (0, 0)
    assert out["cuda"][:2] == out["cpu"][:2]
    assert [f[0] for f in out["cuda"][0]] == infos and out["cuda"][1] == 1


def test_blocked_stream_from_a_file_matches_cpu(dev, tmp_path):
    """The pinned-buffer feed of an IQDat file to the card, every block
    through the kernel (block 0 after its few history outputs), against the
    same stream on the CPU."""
    n = 1_300_017
    raw = np.random.default_rng(1).integers(0, 256, 2 * n).astype(np.uint8)
    p = tmp_path / "c.dat"
    raw.tofile(p)
    fe = _fe()
    before = ddc.LAUNCHES
    got, rate = fe.process(sources.IQDat(str(p), FS), block_size=300_000,
                           device=dev)
    assert ddc.LAUNCHES - before == 5          # one a block
    ref, _ = fe.process(sources.IQDat(str(p), FS), block_size=300_000,
                        device="cpu")
    assert rate == fe.out_rate and got.shape == ref.shape
    _phase_close(got, ref)


def test_stream_carry_moves_between_devices(dev):
    """A stream started on the CPU hands its carry to one on the card."""
    n_blk = 200_000
    raw = torch.from_numpy(np.random.default_rng(2).integers(0, 256, 6 * n_blk)
                           .astype(np.uint8))
    fe = _fe()
    cpu = DdcFmStream(fe, "cpu")
    ref = [cpu.step(raw[2 * i * n_blk: 2 * (i + 1) * n_blk], i * n_blk)
           for i in range(3)]
    first = DdcFmStream(fe, "cpu")
    first.step(raw[: 2 * n_blk], 0)
    card = DdcFmStream(fe, dev)
    assert first.hist.dtype == torch.uint8      # a raw stream carries its bytes
    card.load_state(None, first.c_prev.numpy(), first.hist.numpy())
    for i in (1, 2):
        got = card.step(raw[2 * i * n_blk: 2 * (i + 1) * n_blk].to(dev), i * n_blk)
        _phase_close(got.cpu(), ref[i])


def test_noaa_decode_on_the_card_matches_cpu(dev, monkeypatch):
    """A 24-line pass held on the card (the resident front end: one K1
    launch over the whole capture) decodes as on the CPU."""
    monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 4_000_000)
    raw, truth = synth_pass_bytes(24, dev, seed=3)
    out = {}
    for where, data in (("cuda", raw), ("cpu", raw.cpu())):
        before = ddc.LAUNCHES
        dec = NoaaDecoder(sources.DeviceRawSource(data, FS), 30000, device=where)
        out[where] = (dec.useful, dec.get_crude_sync(), dec.get_image(),
                      dec.get_accurate_sync(), ddc.LAUNCHES - before)
    useful, (sa, sb), img, acc, launches = out["cuda"]
    r_useful, (ra, rb), r_img, r_acc, r_launches = out["cpu"]
    assert launches == 1 and r_launches == 0
    assert useful == r_useful == 1
    assert np.array_equal(sa, ra) and np.array_equal(sb, rb)
    assert img.shape == r_img.shape == (24, 2080)
    d = np.abs(img.astype(np.int64) - r_img.astype(np.int64))
    assert d.max() <= 1 and np.mean(d > 0) < 0.01
    for i in (0, 4):
        assert len(acc[i]) == len(r_acc[i]) > 0
        assert np.max(np.abs(np.subtract(acc[i], r_acc[i]))) <= 1


def test_noaa_one_block_equals_the_block_plan_on_the_card(dev, monkeypatch,
                                                          tmp_path):
    """A 24-line pass held on the card goes through K1 as one block; the
    same bytes from a .dat file go block by block (PROC_CHUNKSIZE 4 M, one
    launch a block). K1 computes every output alike, so the audio is equal
    bit for bit and so are the crude syncs."""
    monkeypatch.setattr(constants, "PROC_CHUNKSIZE", 4_000_000)
    raw, _ = synth_pass_bytes(24, dev, seed=3)
    path = tmp_path / "pass.dat"
    raw.cpu().numpy().tofile(path)
    out = {}
    for plan, src in (("one", sources.DeviceRawSource(raw, FS)),
                      ("blocks", sources.IQDat(str(path), FS))):
        before = ddc.LAUNCHES
        dec = NoaaDecoder(src, 30000, device=dev)
        syncs = dec.get_crude_sync()
        out[plan] = (dec._audio[0], syncs, ddc.LAUNCHES - before)
    n = raw.shape[0] // 2
    assert out["one"][2] == 1 and out["blocks"][2] == -(-n // 4_000_000)
    assert torch.equal(out["one"][0], out["blocks"][0])
    for a, b in zip(out["one"][1], out["blocks"][1]):
        assert np.array_equal(a, b) and len(a) > 0


def test_noaa_bank_on_the_card_equals_one_channel_decodes(dev):
    """Three NOAA passes in one capture (the `noaa_apt_3sat` channels, 24
    lines) held on the card: the bank makes one K1 launch for all channels,
    and each channel's crude syncs, usefulness and image equal those of a
    one-channel decode at its offset over the same bytes. The accurate
    syncs run the same chain in other batches, whose FFT and convolution
    plans may move a tied correlation maximum by one sample (as two
    processes' one-channel decodes may differ): positions within one
    sample, under 2 % of them moved, qualities within 1e-6."""
    from benchmarks.synth import apt_bank
    from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmarks", "configs", "noaa_apt_3sat.json")) as f:
        cfg = json.load(f)
    offsets = [ch["offset_hz"] for ch in cfg["channels"]]
    raw, _ = apt_bank.pass_bytes(24, cfg, 0.05, dev, 2 ** 31 + 22)
    before = ddc.LAUNCHES
    bank = NoaaBankDecoder(sources.DeviceRawSource(raw, FS), offsets, device=dev)
    assert bank.useful == [1, 1, 1]
    got = [(ch.get_crude_sync(), ch.get_image(), ch.get_accurate_sync())
           for ch in bank.channels]
    assert ddc.LAUNCHES - before == 1
    moved = total = 0
    for (crude, img, acc), off in zip(got, offsets):
        one = NoaaDecoder(sources.DeviceRawSource(raw, FS), off, device=dev)
        for a, b in zip(crude, one.get_crude_sync()):
            assert np.array_equal(a, b) and len(a) > 0
        assert np.array_equal(img, one.get_image())
        want = one.get_accurate_sync()
        for i in (0, 4):
            assert len(acc[i]) == len(want[i]) > 0
            d = np.abs(np.subtract(acc[i], want[i]))
            assert d.max() <= 1
            moved, total = moved + int(np.count_nonzero(d)), total + len(d)
            assert np.max(np.abs(np.subtract(acc[i + 2], want[i + 2]))) <= 1e-6
    assert moved <= 0.02 * total, (moved, total)


def _psk(kind):
    cls = FuncubeDecoder if kind == "bpsk" else MeteorM2Decoder
    det = cls(sources.ArraySource(np.zeros(16, np.complex64), FS), 0, device="cpu")
    return det.p, det.cfg.sym_sync, det.cfg.sym_sync_alt


def _same_symbols(got, want):
    assert got.count == want.count > 0
    for a, b in zip((got.a_idx, got.minsync, got.chosen),
                    (want.a_idx, want.minsync, want.chosen)):
        assert torch.equal(a.cpu(), b)
    assert float((got.phase_out.cpu() - want.phase_out).abs().max()) < 1e-6


@pytest.mark.parametrize("segments", [1, 8])
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_scan_kernel_matches_plain(dev, kind, segments):
    x = torch.from_numpy(k3_streams(600_000, seed=4)[kind])
    p, s0, s1 = _psk(kind)
    before = pll.LAUNCHES
    if segments == 1:
        st_k, got = pll.symbol_scan(p, x.to(dev), pll.initial_state(p, len(s0), 1, dev),
                                    s0, s1)
        st_p, want = pll.symbol_scan_plain(p, x, pll.initial_state(p, len(s0), 1, "cpu"), s0, s1)
        assert torch.equal(st_k["i"].cpu(), st_p["i"])
        assert torch.equal(st_k["f"].cpu(), st_p["f"])
    else:
        got, seg_k, own_k = pll.symbol_scan_segments(p, x.to(dev), s0, s1, segments, 500)
        want, seg_p, own_p = pll.symbol_scan_segments(p, x, s0, s1, segments, 500)
        assert torch.equal(seg_k.cpu(), seg_p) and torch.equal(own_k.cpu(), own_p)
    assert pll.LAUNCHES == before + 1
    _same_symbols(got, want)
    if kind == "bpsk":
        assert int(want.minsync.sum()) >= 1
    if segments == 1:                     # the window served every read
        assert pll.LAST_STATS == {"window_misses": [0], "sincos_fallbacks": [1]}


def test_scan_kernel_block_split_carry(dev):
    """Two blocks with the state carried on the card (stage-1 carry across
    the boundary) equal the plain version's two blocks."""
    x = torch.from_numpy(k3_streams(400_000, seed=5)["bpsk"])
    p, s0, s1 = _psk("bpsk")
    _, whole = pll.symbol_scan_plain(p, x, pll.initial_state(p, 330, 1, "cpu"), s0, s1)
    split = int(whole.a_idx[1000]) + 100
    st = pll.initial_state(p, 330, 1, dev)
    st, first = pll.symbol_scan(p, x[:split].to(dev), st, s0, s1)
    assert int(st["i"][0, pll.I_STAGE]) == 1
    st["i"][:, pll.I_ANCHOR] -= split
    st, second = pll.symbol_scan(p, x[split:].to(dev), st, s0, s1)
    got = pll.Symbols(torch.cat([first.a_idx, second.a_idx + split]),
                      *(torch.cat([a, b]) for a, b in zip(first[1:], second[1:])))
    _same_symbols(got, whole)


def test_scan_kernel_budget_and_arguments(dev):
    """The QPSK timing runs backwards on this stream, so the scan ends at
    the step budget on both sides; mixed devices and a bad sync raise."""
    x = torch.from_numpy(k3_streams(300_000, seed=6)["qpsk"])
    p, s0, s1 = _psk("qpsk")
    _, got = pll.symbol_scan(p, x.to(dev), pll.initial_state(p, 120, 1, dev), s0, s1)
    _, want = pll.symbol_scan_plain(p, x, pll.initial_state(p, 120, 1, "cpu"), s0, s1)
    assert got.count == pll.max_symbols(p, 300_000)
    _same_symbols(got, want)
    with pytest.raises(ValueError):
        pll.symbol_scan(p, x.to(dev), pll.initial_state(p, 120, 1, "cpu"), s0, s1)
    with pytest.raises(ValueError):
        pll.symbol_scan(p, x.to(dev), pll.initial_state(p, 120, 1, dev), s0, s1[:-1])


@pytest.mark.parametrize("segments", [None, 4])
def test_funcube_decode_on_the_card_matches_cpu(dev, segments):
    raw, starts = synth_funcube_bytes(11.0, dev, seed=7)
    out = {}
    for where, data in (("cuda", raw), ("cpu", raw.cpu())):
        before = pll.LAUNCHES
        dec = FuncubeDecoder(sources.DeviceRawSource(data, FS), FC_OFFSET_HZ,
                             n_segments=segments, device=where)
        out[where] = (dec.get_syncs(), dec.useful, pll.LAUNCHES - before)
    assert out["cuda"][2] == 1 and out["cpu"][2] == 0
    assert out["cuda"][1] == out["cpu"][1] == 1
    assert len(out["cuda"][0]) == len(out["cpu"][0]) == len(starts) - 1
    assert np.max(np.abs(np.subtract(out["cuda"][0], out["cpu"][0]))) <= 2


def test_funcube_block_loop_on_the_card_matches_cpu(dev):
    raw, starts = synth_funcube_bytes(11.0, dev, seed=8)
    out = {}
    for where, data in (("cuda", raw), ("cpu", raw.cpu())):
        before = pll.LAUNCHES
        dec = FuncubeDecoder(sources.DeviceRawSource(data, FS), FC_OFFSET_HZ,
                             block_size=4_000_000, device=where)
        out[where] = (dec.get_syncs(), dec.useful, pll.LAUNCHES - before)
    assert out["cuda"][2] == 6 and out["cpu"][2] == 0
    assert out["cuda"][1] == out["cpu"][1] == 1 and len(out["cuda"][0]) == 1
    assert np.max(np.abs(np.subtract(out["cuda"][0], out["cpu"][0]))) <= 2


def _meteor_capture(dev):
    """A 3-s Meteor capture of the benchmark's QPSK synthesizer."""
    from benchmarks.synth import qpsk
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmarks", "configs", "meteor_qpsk.json")) as f:
        cfg = json.load(f)
    raw, starts = qpsk.pass_bytes(
        3.0, cfg["sample_rate"], cfg["symbol_rate"], cfg["sync_entries"], 0.05,
        cfg["frame_spacing_s"], cfg["amplitude"], cfg["rrc_rolloff"],
        cfg["rrc_span_symbols"] // 2, cfg["offset_hz"] + cfg["carrier_error_hz"],
        2.0, int(cfg["pll"]["minsync_thresh"]), dev, 2 ** 31 + 16)
    return MeteorM2Decoder, raw, 4000, starts


def _funcube_capture(dev):
    raw, starts = synth_funcube_bytes(11.0, dev, seed=8)
    return FuncubeDecoder, raw, FC_OFFSET_HZ, starts


@pytest.mark.parametrize("capture, block_size", [
    (_funcube_capture, 4_000_000), (_funcube_capture, None),
    (_meteor_capture, 1_000_000)], ids=["funcube_blocks", "funcube_whole",
                                        "meteor_blocks"])
def test_pass2_batch_on_the_card_matches_cpu(dev, monkeypatch, capture, block_size):
    """Pass 2 on the card against pass 2 on the CPU over the same blocks:
    every block the card's pass 2 takes is copied to a CPU pass 2 as well,
    and each device batch runs under `torch.cuda.set_sync_debug_mode` at
    "error", so a batch that waits for the card raises. The syncs of the
    two must be equal; the card's reach the host once."""
    twins, copies = {}, []
    add, run, syncs = (psk_sync._Pass2.add_block, psk_sync._Pass2._run,
                       psk_sync._Pass2.syncs)

    def add_block(self, x_f, start, syms, shift, final):
        if self.device.type == "cuda":
            if self not in twins:
                cpu = object.__new__(type(self.dec))
                cpu.cfg = self.cfg
                cpu._init_device("cpu")
                twins[self] = psk_sync._Pass2(cpu)
            twins[self].add_block(x_f.cpu(), start,
                                  pll.Symbols(*(t.cpu() for t in syms)), shift, final)
        return add(self, x_f, start, syms, shift, final)

    def run_checked(self, windows, jobs):
        if self.device.type != "cuda":
            return run(self, windows, jobs)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(self, windows, jobs)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    def counted(self):
        copies.append(self.device.type)
        return syncs(self)
    monkeypatch.setattr(psk_sync._Pass2, "add_block", add_block)
    monkeypatch.setattr(psk_sync._Pass2, "_run", run_checked)
    monkeypatch.setattr(psk_sync._Pass2, "syncs", counted)
    cls, raw, offset, starts = capture(dev)
    dec = cls(sources.DeviceRawSource(raw, FS), offset, block_size=block_size,
              device=dev)
    got = dec.get_syncs()
    assert dec.useful == 1 and len(got) >= len(starts) - 2
    assert copies == ["cuda"]
    (card, cpu), = twins.items()
    assert card.syncs() == cpu.syncs()
    assert card.dec.counters["psk.pass2.correlations"] == len(got) + 1
    assert card.dec.counters["psk.pass2.batches"] >= 1


def test_iir_warm_apply_and_zero_phase_wait_for_nothing(dev):
    """With a design's block constants on the card (one cold call), the
    PSK front end's low-pass over a complex 20 M-sample block (a ragged
    tail of 3,328 samples) and the NOAA image band-pass's `zero_phase`
    run under `torch.cuda.set_sync_debug_mode("error")`: no blocking copy
    to the card and no synchronise. They give the cold call's tensors bit
    for bit."""
    from directdemod_tpu_torch.ops import iir
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(constants.PROC_CHUNKSIZE, dtype=torch.complex64,
                    device=dev, generator=g)
    audio = torch.randn(4_000_000, device=dev, generator=g)

    def run():
        lp = iir.IirFilter.design_butter(FS, constants.FUNCUBE_DEFAULT_BW,
                                         order=6, kind="lowpass")
        bp = iir.IirFilter.design_butter(60235, 400, 4400, order=6,
                                         kind="bandpass")
        y, z = lp.apply(x, lp.initial_state_step(torch.float32, dev))
        return y, z, bp.zero_phase(audio)
    cold = run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        warm = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b in zip(cold, warm):
        assert torch.equal(a, b)


def test_meteor_decode_on_the_card_matches_cpu(dev):
    """The QPSK timing loop steps backwards at times, so the last-ulp
    differences of the two low-pass filters can move the loops' first
    frames while they lock; from the second reported sync on, the card and
    the CPU agree."""
    raw, starts = synth_meteor_bytes(1.2, dev, seed=9)
    out = {}
    for where, data in (("cuda", raw), ("cpu", raw.cpu())):
        dec = MeteorM2Decoder(sources.DeviceRawSource(data, FS), MM_OFFSET_HZ,
                              device=where)
        out[where] = (dec.get_syncs(), dec.useful)
    assert out["cuda"][1] == out["cpu"][1] == 1
    assert len(out["cuda"][0]) == len(out["cpu"][0]) >= len(starts) - 2
    assert np.max(np.abs(np.subtract(out["cuda"][0][1:], out["cpu"][0][1:]))) <= 2


def _same_scan(got, want):
    """Two `pll._scan` results, bit for bit: state rows, symbols, counts,
    truncation flags."""
    (st_k, sy_k, cnt_k, tr_k), (st_p, sy_p, cnt_p, tr_p) = got, want
    assert cnt_k == cnt_p and tr_k == tr_p
    assert torch.equal(st_k["f"].cpu(), st_p["f"]) and torch.equal(st_k["i"].cpu(), st_p["i"])
    for a, b in zip(sy_k, sy_p):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("segments", [33, 64])
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_scan_kernel_segments_over_blocks(dev, kind, segments):
    """More segments than one block of lanes serves: segment 0 scans the
    whole stream (QPSK: up to the step budget, truncated), the others from
    staggered starts into the zeros beyond it, the last from an anchor past
    its end (no symbol at all); counts that are no multiple of the batch."""
    x = torch.from_numpy(k3_streams(300_000, seed=6)[kind])
    p, s0, s1 = _psk(kind)
    starts = [(k * 7919) % 150_000 for k in range(segments)]
    state = pll.initial_state(p, len(s0), segments, "cpu")
    state["i"][segments - 1, pll.I_ANCHOR] = 300_010
    before = pll.LAUNCHES
    got = pll._scan(p, x.to(dev), {k: v.to(dev) for k, v in state.items()},
                    s0, s1, starts, 300_000)
    assert pll.LAUNCHES == before + 1
    want = pll._scan(p, x, state, s0, s1, starts, 300_000)
    _same_scan(got, want)
    counts = want[2]
    assert counts[-1] == 0 and min(counts[:-1]) > 0
    assert any(c % 64 for c in counts[:-1])
    assert want[3][0] == (kind == "qpsk")


@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_scan_kernel_state_over_two_blocks(dev, kind):
    """A scan in two blocks, the state carried on the card: after each
    block the state rows and the symbols equal the plain version's, bit
    for bit."""
    x = torch.from_numpy(k3_streams(400_000, seed=5)[kind])
    p, s0, s1 = _psk(kind)
    split = 200_003
    st_k = pll.initial_state(p, len(s0), 1, dev)
    st_p = pll.initial_state(p, len(s0), 1, "cpu")
    for lo, hi in ((0, split), (split, 400_000)):
        got = pll._scan(p, x[lo:hi].to(dev), st_k, s0, s1, [0], hi - lo)
        want = pll._scan(p, x[lo:hi], st_p, s0, s1, [0], hi - lo)
        _same_scan(got, want)
        assert want[2][0] > 0
        st_k, st_p = got[0], want[0]
        st_k["i"][:, pll.I_ANCHOR] -= hi - lo
        st_p["i"][:, pll.I_ANCHOR] -= hi - lo


def test_scan_kernel_stage_clocks(dev):
    """The measurement build gives the same symbols and nonzero clocks for
    each stage warp; P's sample reads are part of its work."""
    x = torch.from_numpy(k3_streams(200_000, seed=3)["bpsk"]).to(dev)
    p, s0, s1 = _psk("bpsk")
    cyc = pll.stage_cycles(p, x, pll.initial_state(p, len(s0), 1, dev), s0, s1)
    assert all(c > 0 for c in cyc) and max(cyc[:2]) <= cyc[3] and cyc[4] <= cyc[0]


@pytest.mark.parametrize("case", ["backwards", "clamped", "clamped_wide"])
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_scan_kernel_window_misses_stay_exact(dev, kind, case):
    """Reads outside stage P's window: a first step whose timing sends the
    anchor ~20,000 samples back, far past the window's margin behind it
    (those reads are misses, served from device memory); a block whose
    anchor lies before its first sample, so its reads clamp to sample 0
    (served without a read); the same from an anchor below -2^30, which
    takes the 64-bit indices. Every result equals the plain version's."""
    x = torch.from_numpy(k3_streams(300_000, seed=6)[kind])
    p, s0, s1 = _psk(kind)
    state = pll.initial_state(p, len(s0), 1, "cpu")
    if case == "backwards":
        state["i"][0, pll.I_ANCHOR] = 150_000
        state["f"][0, pll.F_TIMING] = 20_000.0
    else:
        state["i"][0, pll.I_ANCHOR] = -50_000 if case == "clamped" else -(2 ** 30) - 12_345
    got = pll._scan(p, x.to(dev), {k: v.to(dev) for k, v in state.items()},
                    s0, s1, [0], 300_000)
    stats = pll.LAST_STATS
    want = pll._scan(p, x, state, s0, s1, [0], 300_000)
    _same_scan(got, want)
    assert want[2][0] > 0
    if case == "backwards":
        assert stats["window_misses"][0] > 0
    else:
        assert stats["window_misses"] == [0]


@pytest.mark.parametrize("scale", [1e21, 1e-21, 0.0])
def test_scan_kernel_operands_beyond_the_short_forms(dev, scale):
    """Samples beyond 2^60 or below 2^-60 (or zero, from the middle on)
    take stage P's division and square root outside the ranges where they
    equal the compiler's, so each batch runs again with the compiler's
    operators: the result still equals the plain version's."""
    x = torch.from_numpy(k3_streams(100_000, seed=7)["qpsk"])
    if scale:
        x = x * scale
    else:
        x[50_000:] = 0
    p, s0, s1 = _psk("qpsk")
    state = pll.initial_state(p, len(s0), 1, "cpu")
    got = pll._scan(p, x.to(dev), {k: v.to(dev) for k, v in state.items()},
                    s0, s1, [0], 100_000)
    want = pll._scan(p, x, state, s0, s1, [0], 100_000)
    _same_scan(got, want)
    assert want[2][0] > 0


def test_scan_kernel_div_sqrt_probe(dev):
    """Stage P's division and square root without their range checks
    (the measurement build's probe) equal the compiler's: the square root
    over every float32 in [1, 2], the division over 2^22 quotients
    mi / m (0 <= mi <= m) and 2^22 quotients 180 / mean, operands spread
    over 2^-60..2^60 on a log scale."""
    ones = torch.arange(0x3F800000, 0x40000001, dtype=torch.int32).view(torch.float32).to(dev)
    _, _, got, want = pll.div_sqrt_probe(ones, ones)
    assert torch.equal(got, want)
    g = torch.Generator(device=dev).manual_seed(19)
    n = 2 ** 22
    m = torch.exp2(torch.rand(n, generator=g, device=dev) * 119.9 - 60.0)
    mi = m * torch.rand(n, generator=g, device=dev)
    mi = torch.where(mi >= 2.0 ** -60, mi, torch.zeros_like(mi))
    for a, b in ((mi, m), (torch.full_like(m, 180.0), m)):
        got, want, _, _ = pll.div_sqrt_probe(a, b)
        assert torch.equal(got, want)


def test_scan_kernel_cos_sin_probe(dev):
    """Stage C's cos and sin (the measurement build's probe) over 2^24
    phases in (-2 pi, 2 pi), the floats within 64 ulps of each k pi / 2
    among them: equal to the double sincos rounded to float32 everywhere,
    the full sincos run for at most 1e-4 of them."""
    n = 2 ** 24
    grid = torch.linspace(-2 * np.pi, 2 * np.pi, n, dtype=torch.float64).float()
    near = [np.arange(0, 65, dtype=np.int32).view(np.float32)]   # 0 and subnormals
    for k in range(1, 5):
        bits = np.float32(k * np.pi / 2).view(np.int32) + np.arange(-64, 65, dtype=np.int32)
        near += [bits.view(np.float32), -bits.view(np.float32)]
    near = torch.from_numpy(np.concatenate(near))
    x = torch.cat([near, grid[: n - near.shape[0]]]).to(dev)
    c, s, c_ref, s_ref, fb = pll.cos_sin_probe(x)
    assert torch.equal(c, c_ref) and torch.equal(s, s_ref)
    assert int(fb.sum()) <= n * 1e-4


# ------------------------------------------------------------------ the mesh
# A mesh that names the card several times (one card carries every shard,
# one after the other): the sharded paths take the same kernels as the
# sequential ones, and each kernel's output does not depend on the launch,
# so the two agree bit for bit.

def _card_mesh(dev, time=4, channel=1):
    from directdemod_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(time=time, channel=channel, devices=[dev] * (time * channel))


def _mesh_source(kind, n, dev, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "u8":
        raw = torch.from_numpy(rng.integers(0, 256, 2 * n).astype(np.uint8)).to(dev)
        return sources.DeviceRawSource(raw, FS)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    return sources.ArraySource(x, FS)


@pytest.mark.parametrize("kind", ["u8", "c64"])
@pytest.mark.parametrize("bw", [60000, 5000])          # J = 34, 409
def test_sharded_front_end_equals_sequential_bit_for_bit(dev, kind, bw):
    """ShardedDdcFm over bytes (K1) and complex64 (K4) on a 4-shard mesh of
    the card: two whole waves, a leftover block and a ragged tail, at an odd
    block length (each block at another decimator phase)."""
    from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
    block = 300_007
    src = _mesh_source(kind, 9 * block + 12_345, dev)
    fe = _fe(bw)
    ref, rate = fe.process(src, block_size=block, device=dev)
    counter = "LAUNCHES" if kind == "u8" else "LAUNCHES_C64"
    before = getattr(ddc, counter)
    got, rate2 = ShardedDdcFm(fe, _card_mesh(dev)).process(src, block)
    assert getattr(ddc, counter) - before >= 8      # one a block of the waves
    assert rate == rate2 and got.shape == ref.shape
    assert np.array_equal(got, ref)


def test_stream_run_sharded_equals_run_fused_on_the_card(dev):
    from directdemod_tpu_torch.stream.api import Stream
    src = _mesh_source("c64", 2_000_000 + 777, dev, seed=5)
    chain = (Stream(src, device=dev).shift(30000).filter(design.blackmanharris(151))
             .bw_limit(60000).fm_demod())
    ref, rate = chain.run_fused(block_size=250_000)
    got, rate2 = chain.run_sharded(_card_mesh(dev), block_size=250_000)
    assert rate == rate2 and np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["u8", "c64"])
def test_bank_on_a_channel_mesh_equals_the_bank(dev, kind):
    """MultiDdcFm on a 1 x 3 channel mesh of the card: one kernel launch a
    block on each shard, each channel equal to the unsharded bank's."""
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    src = _mesh_source(kind, 3 * 400_000 + 99, dev, seed=6)
    freqs = (120_000, 412_500, -400_000)
    taps = design.blackmanharris(151)
    ref, _ = MultiDdcFm(FS, freqs, taps, 60000).process(src, 400_000, device=dev)
    counter = "LAUNCHES" if kind == "u8" else "LAUNCHES_C64"
    before = getattr(ddc, counter)
    got, _ = MultiDdcFm(FS, freqs, taps, 60000,
                        mesh=_card_mesh(dev, time=1, channel=3)).process(src, 400_000)
    assert getattr(ddc, counter) - before == 3 * 4    # 3 shards x 4 blocks
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_scan_kernel_over_a_mesh_equals_one_launch(dev, kind):
    """symbol_scan_segments(mesh=): one K3 launch a shard over its own
    segments, the same symbols as one launch over all of them."""
    x = torch.from_numpy(k3_streams(600_000, seed=4)[kind]).to(dev)
    p, s0, s1 = _psk(kind)
    want = pll.symbol_scan_segments(p, x, s0, s1, 8, 500)
    before = pll.LAUNCHES
    got = pll.symbol_scan_segments(p, x, s0, s1, 8, 500, mesh=_card_mesh(dev))
    assert pll.LAUNCHES == before + 4
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_mesh_naming_the_card_twice(dev):
    """Two shards on one card: a ppermute'd halo is a copy of its sender,
    an all_gather stacks every shard's tensor on each shard's device."""
    from directdemod_tpu_torch.parallel import mesh as pmesh
    m = pmesh.make_mesh(time=2, devices=[dev, dev])
    assert m.time_devices == [dev, dev] and m.shape == {"time": 2, "channel": 1}
    a = torch.arange(8.0, device=dev)
    out = pmesh.ppermute([a, a + 1], [(0, 1)], m.time_devices)
    assert torch.equal(out[1], a) and out[1].data_ptr() != a.data_ptr()
    g = pmesh.all_gather([a, a + 1], m.time_devices)
    assert g[0].device == dev and torch.equal(g[0][1], a + 1)
    with pytest.raises(ValueError, match="2x1 mesh needs 2 devices, have 1"):
        pmesh.make_mesh(time=2)


def test_two_processes_on_the_card_equal_one_process(dev, tmp_path):
    """The mesh over two processes (gloo on localhost, `chip_smoke.py
    --worker`), each owning two `time` shards that name the card: K1 over
    raw bytes that each rank reads from a .dat file, three waves and two
    blocks after them (on rank 0), every output on both ranks bit for bit
    the one-process 4-shard run, and K1 launched by both ranks."""
    import json
    from directdemod_tpu_torch.parallel import distributed
    from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    raw, _ = synth_pass_bytes(40, dev, seed=4)
    raw.cpu().numpy().tofile(tmp_path / "noaa.dat")
    blk = 3_000_000
    want, _ = ShardedDdcFm(_fe(60000), _card_mesh(dev)).process(
        sources.IQDat(str(tmp_path / "noaa.dat"), FS), blk)
    np.save(tmp_path / "g_ref.npy", want)
    (tmp_path / "spec.json").write_text(json.dumps({"block": blk}))
    port = str(distributed.free_port())
    runs = distributed.launch(
        [[os.path.join(root, "chip_smoke.py"), "--worker", str(r), "2", port,
          str(tmp_path), "g"] for r in range(2)],
        timeout_s=300, env=dict(os.environ, PYTHONPATH=root), cwd=str(tmp_path))
    for code, text in runs:
        assert code == 0, text[-3000:]
    res = [json.loads(line[len("WORKER "):]) for _, text in runs
           for line in text.splitlines() if line.startswith("WORKER ")]
    assert [(w["rank"], w["n_diff"], w["outputs"]) for w in res] == \
        [(0, 0, len(want)), (1, 0, len(want))]
    launches = [w["launches"] for w in res]
    assert min(launches) > 0 and sum(launches) == -(-(raw.shape[0] // 2) // blk)
