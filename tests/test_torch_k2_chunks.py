"""K2's chunk-speculative walk, pass for pass, as a Python model on the CPU.

The CUDA kernel `directdemod_tpu_torch/csrc/lookahead_walk.cu` walks the
lookahead peak walk in three passes: speculative walks of every chunk from
the two states a fire resets to (chunk 0 from the true initial state), each
recording its (mx, mn) every CHECKPOINT samples; a stitch that walks each
chunk from its true entering state until it fires an event that one of the
chunk's speculative walks also fires (same index, same kind), or until its
(mx, mn) equal a walk's at a checkpoint, and adopts that walk from there;
and a gather of the adopted events, which gives an adopted event whose
position was set before a checkpoint meeting the true walk's position.
The kernel runs only on a card, so `chunked_walk` below is the same three
passes in Python, step for step the kernel's (the step is the plain
version's, thresholds y -/+ delta in float32), and each test holds its
events equal, field for field, to `peaks.lookahead_walk_plain`'s, the
sequential walk. Inputs are seeded; tolerance: none (exact).
"""
import math
import os
import struct
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import (APRS_OFFSET_HZ, FS, stress_edges,  # noqa: E402
                        synth_aprs_bytes)
from directdemod_tpu_torch import constants  # noqa: E402
from directdemod_tpu_torch.io.sources import DeviceRawSource  # noqa: E402
from directdemod_tpu_torch.models.afsk1200 import Afsk1200Decoder  # noqa: E402
from directdemod_tpu_torch.ops import peaks  # noqa: E402

torch.set_num_threads(1)

INF = math.inf
CHECKPOINT = 32                   # samples between recorded (mx, mn)
INIT = (-INF, INF, 0, 0)          # (mx, mn, mxpos, mnpos)
POST_MAX = (INF, INF, 0, 0)
POST_MIN = (-INF, -INF, 0, 0)


def chunked_walk(y: torch.Tensor, fmax: torch.Tensor, fmin: torch.Tensor,
                 delta: float, chunk: int):
    """K2's three passes over chunks of `chunk` samples. Returns (events as
    (index, position, value, is_max) tuples, the stitch's steps in each
    chunk, whether it met a speculative walk in each chunk, the events of
    each chunk's speculative walks)."""
    d = torch.tensor(float(delta), dtype=torch.float32)
    ys, fxs, fns = y.tolist(), fmax.tolist(), fmin.tolist()
    ymd, ypd = (y - d).tolist(), (y + d).tolist()
    limit = len(ys)
    n_chunks = -(-limit // chunk)
    cap = chunk // 2 + 2

    def same_bits(a, b):          # equal as float32 bit patterns
        return struct.pack("<ff", *a) == struct.pack("<ff", *b)

    def step(st, i):
        mx, mn, mxpos, mnpos = st
        yi = ys[i]
        if yi > mx:
            mx, mxpos = yi, i
        if yi < mn:
            mn, mnpos = yi, i
        # a finite mx is y[mxpos], so mx - delta in float32 is ymd[mxpos]
        if math.isfinite(mx) and yi < ymd[mxpos] and fxs[i] < mx:
            return (INF, INF, mxpos, mnpos), (i, mxpos, mx, True)
        if math.isfinite(mn) and yi > ypd[mnpos] and fns[i] > mn:
            return (-INF, -INF, mxpos, mnpos), (i, mnpos, mn, False)
        return (mx, mn, mxpos, mnpos), None

    # pass 1: the speculative walks, two a chunk, with their checkpoints
    spec = []
    for c in range(n_chunks):
        lo, hi = c * chunk, min(limit, (c + 1) * chunk)
        walks = []
        for start in ((INIT,) if c == 0 else (POST_MAX, POST_MIN)):
            st, ev, cps = start, [], []
            for i in range(lo, hi):
                st, e = step(st, i)
                if e is not None:
                    ev.append(e)
                if (i - lo + 1) % CHECKPOINT == 0:
                    cps.append(st[:2])
            assert len(ev) <= cap
            walks.append((ev, st, cps))
        spec.append(walks)

    # pass 2: the stitch, in chunk order
    out, records, steps = [], [], []
    st = INIT
    for c in range(n_chunks):
        lo, hi = c * chunk, min(limit, (c + 1) * chunk)
        src, frm, walked, meet, fix = None, 0, 0, -1, None
        if c == 0:
            src = 0
        elif st[:2] == (INF, INF):
            src = 0
        elif st[:2] == (-INF, -INF):
            src = 1
        else:
            ptr = [0, 0]
            for i in range(lo, hi):
                walked += 1
                st, e = step(st, i)
                if e is not None:
                    out.append(e)
                    for w in (0, 1):
                        ev = spec[c][w][0]
                        while ptr[w] < len(ev) and ev[ptr[w]][0] < i:
                            ptr[w] += 1
                        if ptr[w] < len(ev) and ev[ptr[w]][0] == i and ev[ptr[w]][3] == e[3]:
                            src, frm = w, ptr[w] + 1
                            break
                    if src is not None:
                        break
                if (i - lo + 1) % CHECKPOINT == 0:
                    j = (i - lo + 1) // CHECKPOINT - 1
                    for w in (0, 1):
                        if same_bits(st[:2], spec[c][w][2][j]):
                            ev = spec[c][w][0]
                            src, meet, fix = w, i, st[2:]
                            frm = sum(1 for x in ev if x[0] <= i)
                            break
                    if src is not None:
                        break
        n = 0
        if src is not None:
            ev, ex, _ = spec[c][src]
            n = len(ev) - frm
            # positions set before a checkpoint meeting are the true walk's
            st = (ex[0], ex[1], fix[0] if ex[2] <= meet else ex[2],
                  fix[1] if ex[3] <= meet else ex[3]) if fix else ex
        records.append((src, frm, len(out), n, meet, fix))
        steps.append(walked)
        out.extend([None] * n)

    # pass 3: the gather
    for c, (src, frm, dst, n, meet, fix) in enumerate(records):
        if src is not None:
            out[dst:dst + n] = [
                (i, fix[0 if is_max else 1] if pos <= meet else pos, v, is_max)
                for i, pos, v, is_max in spec[c][src][0][frm:frm + n]]
    met = [r[0] is not None for r in records]
    return out, steps, met, [[w[0] for w in walks] for walks in spec]


def _walk_args(y: torch.Tensor, lookahead: int):
    limit = y.shape[0] - lookahead
    fmax, fmin = peaks.forward_window_extrema(y, lookahead)
    return y[:limit].contiguous(), fmax[:limit].contiguous(), fmin[:limit].contiguous()


def _check(y: torch.Tensor, lookahead: int, delta: float, chunk: int,
           events: bool = True):
    """The model's events equal the plain walk's (of which there are some,
    if `events`); returns the model's (events, steps, met, speculative
    events)."""
    args = _walk_args(y, lookahead)
    got = chunked_walk(*args, delta, chunk)
    want = list(zip(*(t.tolist() for t in peaks.lookahead_walk_plain(*args, delta))))
    assert (len(want) > 0) == events
    assert got[0] == want
    assert len(got[1]) == -(-args[0].shape[0] // chunk)
    return got


@pytest.mark.parametrize("delta", [0.0, 0.1])
@pytest.mark.parametrize("chunk", [1, 2, 3, 7, 64])
def test_stress_input(chunk, delta):
    _check(stress_edges(3000, 11, "cpu"), 11, delta, chunk)


@pytest.mark.parametrize("chunk", [3, 5, 7])
def test_events_at_chunk_boundaries(chunk):
    """A fire at every odd index: with an odd chunk length events fall on
    the first and on the last sample of chunks (a speculative walk cannot
    fire on its first sample, so the stitch takes those)."""
    y = torch.tensor([1.0, 0.0, 0.0, 1.0] * 300)
    events, _, met, _ = _check(y, 1, 0.0, chunk)
    idx = [e[0] for e in events]
    assert any(i % chunk == 0 for i in idx)
    assert any(i % chunk == chunk - 1 for i in idx)
    assert sum(met) > len(met) // 2


@pytest.mark.parametrize("chunk", [7, 64])
def test_chunks_without_events(chunk):
    """Flat stretches (constant y) fire nothing: whole chunks without an
    event, on both speculative walks."""
    y = stress_edges(4000, 3, "cpu")
    y[500:1500] = 0.25
    y[2500:3200] = 0.0
    _, _, _, spec = _check(y, 11, 0.0, chunk)
    assert any(not w0 and not w1 for w0, w1 in (s for s in spec[1:]))


@pytest.mark.parametrize("chunk", [40, 64])
def test_monotone_ramp(chunk):
    """On a rising ramp the true walk fires one min and then only tracks
    its max: no chunk after the first has an event to meet at, but from
    the first checkpoint on its (mx, mn) is the post-min walk's."""
    y = torch.arange(1000, dtype=torch.float32)
    events, steps, met, _ = _check(y, 5, 0.0, chunk)
    assert len(events) == 1 and not events[0][3]
    assert all(met) and steps[1:-1] == [CHECKPOINT] * (len(steps) - 2)


@pytest.mark.parametrize("chunk", [7, 64])
def test_monotone_ramp_never_meets(chunk):
    """A rising ramp with a delta larger than its range never fires, and
    its true (mx, mn) = (y, y[0]) is neither walk's, (inf, y[lo]) or (y,
    -inf): no chunk after the first meets, so the stitch walks them whole."""
    y = torch.arange(1000, dtype=torch.float32)
    _, steps, met, _ = _check(y, 5, 1e6, chunk, events=False)
    limit = 1000 - 5
    for c in range(1, len(steps)):
        assert not met[c] and steps[c] == min(chunk, limit - c * chunk)


@pytest.mark.parametrize("delta", [0.0, 0.1])
@pytest.mark.parametrize("chunk", [3, 64])
def test_infinities_and_nans(chunk, delta):
    y = stress_edges(3000, 5, "cpu")
    rng = np.random.default_rng(5)
    for v in (math.inf, -math.inf, math.nan):
        y[torch.from_numpy(rng.choice(3000, 12, replace=False))] = v
    _check(y, 11, delta, chunk)


@pytest.fixture(scope="module")
def afsk_edges():
    raw, _ = synth_aprs_bytes(1.5, "cpu", seed=3)
    dec = Afsk1200Decoder(DeviceRawSource(raw, FS), APRS_OFFSET_HZ, device="cpu")
    return dec._edges()[1]


@pytest.mark.parametrize("chunk", [64, 1024, 4096])
def test_afsk_edge_strength(afsk_edges, chunk):
    """The real AFSK edge strength. Between frames it is exactly zero: no
    walk fires there, and a chunk that starts in such a stretch meets a
    walk at a checkpoint, its (mx, mn) being the post-max walk's."""
    lookahead = int(constants.AFSK_DEFAULT_BW // constants.AFSK_BAUDRATE * 0.65)
    _, steps, met, _ = _check(afsk_edges, lookahead, 0.0, chunk)
    limit = afsk_edges.shape[0] - lookahead
    assert all(met)
    assert max(steps) <= max(CHECKPOINT, 200)


def _interpolated_tone(period: int, periods: int) -> torch.Tensor:
    """A unit tone of `period` samples a period, FFT-interpolated 32x as
    `ops.peaks_extra.peaks_fft` interpolates (mid-spectrum zero pad), in
    float32 as the walk reads it."""
    from directdemod_tpu_torch.ops.peaks_extra import _fft_interp
    seg = torch.sin(2 * math.pi * torch.arange(period * periods, dtype=torch.float64)
                    / period)
    return _fft_interp(seg, 32 * period * periods).float()


@pytest.mark.parametrize("chunk", [64, 256])
def test_lookahead_500_on_an_interpolated_tone(chunk):
    """`peaks_fft`'s walk: lookahead 500 over a smooth waveform of 1,024
    samples a period, whose half-period (512) is longer than the chunk, so
    most chunks hold no fire. Such a chunk meets a speculative walk at its
    first checkpoint; after the first fire the stitch walks a chunk whole
    only between an extremum and its fire (there the true (mx, mn) is set
    before the chunk) or when the chunk is shorter than a checkpoint."""
    y = _interpolated_tone(32, 8)
    delta = 2 * float((2 * math.sin(math.pi / 32)))      # peaks_fft's 2 max|dy|
    events, steps, met, _ = _check(y, 500, delta, chunk)
    assert len(events) == 15                             # one a half-period
    fires = {e[0] // chunk for e in events}
    limit = y.shape[0] - 500
    assert {steps[c] for c in range(1, len(met)) if met[c] and c not in fires} == {CHECKPOINT}
    for c in range(events[0][0] // chunk + 1, len(met)):
        lo, hi = c * chunk, min(limit, (c + 1) * chunk)
        if not met[c]:
            assert hi - lo < CHECKPOINT or any(pos < lo and hi <= i + 1
                                               for i, pos, _, _ in events)
