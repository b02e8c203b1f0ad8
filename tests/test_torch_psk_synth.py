"""`chip_smoke.py`'s PSK synthesizers, decoded by the port on the CPU: the
constant delay between a planted frame and its decoded sync, which the
smoke run holds the 10-minute Funcube and 2-minute Meteor decodes on the
card to (`FC_SYNC_DELAY`, `MM_SYNC_DELAY`), is measured here on short
captures of the same synthesizers. Every planted frame after the first
(the reference drops the first sync) must come back within the smoke run's
tolerance of that delay."""
import numpy as np
import torch

import chip_smoke as cs
from directdemod_tpu_torch.io.sources import DeviceRawSource
from directdemod_tpu_torch.models.funcube import FuncubeDecoder
from directdemod_tpu_torch.models.meteorm2 import MeteorM2Decoder

torch.set_num_threads(1)


def test_funcube_synth_sync_delay():
    raw, starts = cs.synth_funcube_bytes(11.0, "cpu", seed=5)
    assert raw.dtype == torch.uint8 and raw.shape[0] == 2 * 11 * cs.FS
    assert len(starts) == len(cs.funcube_frames(11.0)) == 2
    dec = FuncubeDecoder(DeviceRawSource(raw, cs.FS), cs.FC_OFFSET_HZ,
                         device="cpu")
    syncs = dec.get_syncs()
    assert dec.useful == 1 and len(syncs) == len(starts) - 1
    d = np.asarray(syncs) - starts[1:]
    assert np.all(np.abs(d - cs.FC_SYNC_DELAY) <= 3), d
    assert cs.matched_frames(syncs, starts[1:], cs.FC_SYNC_DELAY,
                             cs.FC_SYNC_TOL) == len(starts) - 1


def test_meteor_synth_sync_delay():
    raw, starts = cs.synth_meteor_bytes(1.4, "cpu", seed=5)
    assert len(starts) == len(cs.meteor_frames(1.4)) == 12
    dec = MeteorM2Decoder(DeviceRawSource(raw, cs.FS), cs.MM_OFFSET_HZ,
                          device="cpu")
    syncs = dec.get_syncs()
    assert dec.useful == 1 and len(syncs) == len(starts) - 1
    d = np.asarray(syncs) - starts[1:]
    assert np.all(np.abs(d - cs.MM_SYNC_DELAY) <= 3), d
    assert cs.matched_frames(syncs, starts, cs.MM_SYNC_DELAY,
                             cs.MM_SYNC_TOL) == len(starts) - 1


def test_matched_frames_counts_each_planted_frame_once():
    starts = np.asarray([1000, 5000, 9000])
    assert cs.matched_frames([1010.0, 5030.0, 9500.0], starts, 10, 25) == 2
    assert cs.matched_frames([], starts, 10, 25) == 0
    assert cs.matched_frames([5010.0], starts, 10, 25) == 1
