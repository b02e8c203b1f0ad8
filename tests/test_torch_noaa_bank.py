"""The NOAA bank decode (`models/noaa_bank.NoaaBankDecoder`) on the CPU: a
seeded 30.25-s capture of three NOAA passes at the `noaa_apt_3sat`
configuration's offsets and amplitudes (`benchmarks/synth/apt_bank.py`),
each channel held to a one-channel `NoaaDecoder` at its offset over the
same bytes and to the configuration's plain reference
(`benchmarks/reference/apt_bank.py`); a capture whose third channel is
noise; the bank's spans and counters; the channel axis of
`ops.am.envelope_blocked` and `ops.correlate.norm_correlate_multi_blocked`.

Stated tolerances:
- against a one-channel decode: crude syncs, usefulness, image and
  accurate-sync positions equal (the bank's front end gives each channel
  its one-channel outputs bit for bit, and the crude sync, image and
  window chain each row's one-channel arithmetic); accurate-sync qualities
  within 1e-6, as the accurate sync's batches hold other windows;
- against the plain reference: the benchmark check's four numbers within
  the configuration's limits (`drivers/noaa.compare`);
- the ops' channel axis: each row bit for bit its 1-D call."""
import json
import os

import numpy as np
import pytest
import torch

from benchmarks.drivers.noaa import compare, crude_sync_deficit
from benchmarks.reference import apt_bank as ref
from benchmarks.synth import apt_bank as synth
from directdemod_tpu_torch import constants
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models import stages
from directdemod_tpu_torch.models.noaa import WINDOW_GROUP, NoaaDecoder, window_starts
from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder
from directdemod_tpu_torch.ops import am, correlate

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2_048_000
SEED = 2 ** 31 + 22
with open(os.path.join(ROOT, "benchmarks", "configs", "noaa_apt_3sat.json")) as f:
    CFG = json.load(f)
OFFSETS = [ch["offset_hz"] for ch in CFG["channels"]]


@pytest.fixture(scope="module")
def capture():
    raw, _ = synth.pass_bytes(60, CFG, 0.05, "cpu", SEED)
    return raw


@pytest.fixture(scope="module")
def bank(capture):
    dec = NoaaBankDecoder(DeviceRawSource(capture, FS), OFFSETS, device="cpu")
    products = [(ch.useful, ch.get_crude_sync(), ch.get_image(), ch.get_accurate_sync())
                for ch in dec.channels]
    return dec, products


@pytest.fixture(scope="module")
def singles(capture):
    out = []
    for off in OFFSETS:
        dec = NoaaDecoder(DeviceRawSource(capture, FS), off, device="cpu")
        out.append((dec.useful, dec.get_crude_sync(), dec.get_image(),
                    dec.get_accurate_sync(), dec.channel_id))
    return out


@pytest.mark.parametrize("c", range(3))
def test_channel_equals_its_one_channel_decode(bank, singles, c):
    useful, crude, img, acc = bank[1][c]
    s_useful, s_crude, s_img, s_acc, s_ids = singles[c]
    assert useful == s_useful == 1
    for a, b in zip(crude, s_crude):
        assert np.array_equal(a, b) and len(a) > 50
    assert img.shape[0] >= 59 and img.shape[1] == 2080 and np.array_equal(img, s_img)
    for i in (0, 4):
        assert acc[i] == s_acc[i] and len(acc[i]) > 50
        assert np.max(np.abs(np.subtract(acc[i + 2], s_acc[i + 2]))) <= 1e-6
    assert bank[0].channels[c].channel_id == s_ids


@pytest.mark.parametrize("c", range(3))
def test_channel_holds_to_the_plain_reference(capture, bank, c):
    """The benchmark check's numbers of channel c, against the
    single-channel plain chain at its offset (its products made at the
    decode's crude syncs, which must be the reference's own up to ties)."""
    useful, crude, img, acc = bank[1][c]
    fr = ref.front(capture, CFG, c)
    assert fr["useful"] == useful == 1
    lim = CFG["limits"]
    assert crude_sync_deficit(crude, fr) <= lim["crude_sync_deficit"]
    want = ref.products(capture, CFG, c, fr, *crude)
    nums = compare(img, acc, crude, fr, want)
    assert set(nums) == {"crude_sync_deficit", "image_share", "accurate_pos_gap",
                         "accurate_quality_gap"}
    for k, v in nums.items():
        assert v <= lim[k], (k, v, lim[k])


def test_channel_views_give_the_decoder_surface(bank):
    dec, products = bank
    for ch, (_, _, img, _) in zip(dec.channels, products):
        assert np.array_equal(ch.image_a, img[:, :1040])
        assert np.array_equal(ch.image_b, img[:, 1040:])
        assert len(ch.channel_id) == 2
        assert ch.offset == OFFSETS[ch.index] and ch.bank is dec
    assert dec.useful == [1, 1, 1]


def test_noise_only_channel_is_not_useful():
    """The third channel silent (amplitude 0, noise only): it reads useful
    0 and makes no image unless asked; the other two decode."""
    cfg = json.loads(json.dumps(CFG))
    cfg["channels"][2]["amplitude"] = 0.0
    raw, _ = synth.pass_bytes(16, cfg, 0.05, "cpu", SEED + 1)
    dec = NoaaBankDecoder(DeviceRawSource(raw, FS), OFFSETS, device="cpu")
    assert dec.useful == [1, 1, 0]
    imgs = [ch.get_image() for ch in dec.channels[:2]]
    assert all(img.shape[0] >= 15 and img.shape[1] == 2080 for img in imgs)
    assert sorted(dec._images) == [0, 1]
    acc = dec.channels[0].get_accurate_sync()
    assert len(acc[0]) > 10
    assert sorted(dec._accurate) == [(0, True), (1, True)]
    one = NoaaDecoder(DeviceRawSource(raw, FS), OFFSETS[1], device="cpu")
    assert np.array_equal(imgs[1], one.get_image())


def test_spans_and_counters_a_decode():
    """Under the profiler: one `noaa_bank.fm_frontend` range a decode, the
    session's tally of `noaa_bank.channels` 3 and `crude_sync.device_rows`
    6, and fewer accurate-sync batches than the channels' own decodes
    would run (windows of different channels share a batch)."""
    raw, _ = synth.pass_bytes(16, CFG, 0.05, "cpu", SEED + 2)
    dec = NoaaBankDecoder(DeviceRawSource(raw, FS), OFFSETS, device="cpu")
    stages.session_counts()      # end a session an earlier test left behind
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for ch in dec.channels:
            ch.get_accurate_sync()
    tally = stages.session_counts()
    names = [e.name for e in prof.events()]
    for stage in ("fm_frontend", "crude_sync", "accurate_sync"):
        assert names.count(f"noaa_bank.{stage}") == 1, stage
    assert tally["noaa_bank.channels"] == 3
    assert tally["noaa_bank.crude_sync.device_rows"] == 6
    width = int(3 * constants.NOAA_T * len(constants.NOAA_SYNCA) * FS)
    per_row = [len(window_starts(s, dec._audio[1], FS, width, dec.src.length))
               for pair in dec.get_crude_sync() for s in pair]
    own = sum(-(-n // WINDOW_GROUP) for n in per_row)
    windows = tally["noaa_bank.accurate_sync.windows"]
    assert windows == sum(per_row)
    assert tally["noaa_bank.accurate_sync.batches"] == -(-windows // WINDOW_GROUP) < own
    assert dec.counters == {k: v for k, v in tally.items() if k.startswith("noaa_bank.")}


@pytest.mark.parametrize("n,block", [(300_000, 24_000), (700_001, 24_000),
                                     (5_000, 24_000), (480_000, 240_000)])
def test_envelope_blocked_channel_axis_bit_for_bit(n, block):
    x = torch.rand(3, n, generator=torch.Generator().manual_seed(n))
    got = am.envelope_blocked(x, block)
    assert got.shape == (3, n)
    for i in range(3):
        assert torch.equal(got[i], am.envelope_blocked(x[i], block))


@pytest.mark.parametrize("n", [5_000, 200_000, 262_144, 400_000, 1_807_050])
def test_norm_correlate_multi_blocked_channel_axis_bit_for_bit(n):
    g = torch.Generator().manual_seed(n)
    x = torch.rand(3, n, generator=g)
    needles = torch.rand(2, 560, generator=g)
    got = correlate.norm_correlate_multi_blocked(x, needles)
    assert got.shape == (3, 2, n)
    for i in range(3):
        assert torch.equal(got[i], correlate.norm_correlate_multi_blocked(x[i], needles))
