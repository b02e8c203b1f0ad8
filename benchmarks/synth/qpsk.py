"""Seeded Meteor-M2 LRPT pass as 8-bit IQ bytes, made on the device.

The shape of `benchmarks/synth/bpsk.pass_bytes`, for QPSK: random symbols
on the I and Q rails, root-raised-cosine shaped, the 120-entry frame sync
planted on the rails (its even entries on I, its odd entries on Q, as
`chip_smoke.synth_meteor_bytes` plants it) every frame spacing, the filler
cleared of windows the detector would take for a sync, moved onto the
carrier with complex noise and quantized like an 8-bit SDR.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmarks.synth.bpsk import _to_bytes


def frame_times(seconds: float, first_s: float, spacing_s: float,
                sym_rate: float, sync_syms: int) -> list:
    """Planted frame times: every `spacing_s` from `first_s` while the sync
    and 0.03 s after it fit (`chip_smoke.meteor_frames`)."""
    out, ft = [], first_s
    while ft + sync_syms / sym_rate + 0.03 < seconds:
        out.append(ft)
        ft += spacing_s
    return out


def rrc(t: np.ndarray, beta: float, span: int) -> np.ndarray:
    """The root-raised-cosine pulse at `t` symbols from its centre, scaled
    to 1 at its peak, zero beyond `span` symbols either side."""
    t = np.asarray(t, np.float64)
    out = np.empty_like(t)
    peak = 1.0 - beta + 4.0 * beta / math.pi
    edge = np.isclose(np.abs(t), 1.0 / (4.0 * beta))
    mid = t == 0.0
    rest = ~edge & ~mid
    tr = t[rest]
    out[rest] = ((np.sin(math.pi * tr * (1.0 - beta))
                  + 4.0 * beta * tr * np.cos(math.pi * tr * (1.0 + beta)))
                 / (math.pi * tr * (1.0 - (4.0 * beta * tr) ** 2)))
    out[mid] = peak
    a = math.pi / (4.0 * beta)
    out[edge] = beta / math.sqrt(2.0) * ((1.0 + 2.0 / math.pi) * math.sin(a)
                                         + (1.0 - 2.0 / math.pi) * math.cos(a))
    out[np.abs(t) > span] = 0.0
    return out / peak


def sync_variants(sync: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The two patterns the detector compares: the sync against the
    (I, Q) register, and the sync with its odd entries flipped against the
    (Q, I) register (`models/meteorm2._variants`)."""
    alt = np.where(np.arange(len(sync)) % 2 == 0, sync, 1 - sync)
    return sync, alt


def _distances(e: torch.Tensor, pattern: np.ndarray) -> torch.Tensor:
    """Hamming distance of `pattern` (0/1) to the window of the 0/1 stream
    `e` (float32, on the device) at every offset."""
    w = torch.as_tensor(pattern, dtype=torch.float32, device=e.device)
    ones = torch.ones_like(w)
    c = torch.nn.functional.conv1d(e[None, None], torch.stack([w, ones])[:, None])[0]
    return (c[1] + float(w.sum()) - 2.0 * c[0]).round()


def clear_false_syncs(bi: np.ndarray, bq: np.ndarray, sync: np.ndarray,
                      keep: np.ndarray, margin: int, rng: np.random.Generator,
                      device) -> None:
    """Flip filler bits until no window of len(sync) / 2 symbols clear of
    the planted frames (`keep`, per symbol) lies within `margin` entries of
    either sync variant or of its complement, in the register the detector
    fills (two entries a symbol: (I, Q) for the sync, (Q, I) for its
    variant). Such a window would fire the detector's minsync; the
    benchmark holds the decoder to the planted frames only."""
    L = len(sync)
    ns = L // 2
    s0, s1 = sync_variants(sync)
    touches = np.convolve(keep, np.ones(ns, int))[ns - 1:len(bi)] > 0
    for _ in range(256):
        e = torch.as_tensor(np.stack([bi, bq], 1).reshape(-1), dtype=torch.float32,
                            device=device)
        e2 = torch.as_tensor(np.stack([bq, bi], 1).reshape(-1), dtype=torch.float32,
                             device=device)
        bad = torch.zeros(len(bi) - ns + 1, dtype=torch.bool, device=device)
        for stream, pat in ((e, s0), (e2, s1)):
            d = _distances(stream, pat)[0::2]
            bad |= (d <= margin) | (d >= L - margin)
        bad = np.flatnonzero(bad.cpu().numpy() & ~touches)
        if len(bad) == 0:
            return
        for w in bad:
            for rails, pat in (((bi, bq), s0), ((bq, bi), s1)):
                win = np.stack([rails[0][w:w + ns], rails[1][w:w + ns]], 1).reshape(-1)
                diff = win != pat
                dw = int(diff.sum())
                if margin < dw < L - margin:
                    continue
                j = np.flatnonzero(~diff if dw <= margin else diff)
                j = int(j[rng.integers(len(j))])
                rails[j % 2][w + j // 2] ^= 1
    raise RuntimeError("could not clear the filler of false syncs")


def pass_bytes(seconds: float, fs: int, sym_rate: int, sync_entries,
               first_s: float, spacing_s: float, amplitude: float, rolloff: float,
               span: int, carrier_hz: int, noise: float, margin: int, device,
               seed: int, chunk: int = 1 << 24) -> tuple[torch.Tensor, np.ndarray]:
    """QPSK capture of `seconds` as interleaved uint8 IQ on `device`:
    `sym_rate` random symbols of +-1 on each rail, each a root-raised-cosine
    pulse of roll-off `rolloff` (`span` symbols either side, centred at the
    symbol's time k fs / sym_rate, its peak `amplitude`), the 120-entry
    sync planted at `frame_times` (entry 2m on I, 2m + 1 on Q of symbol m),
    the filler cleared of near-syncs within `margin` entries, on
    `carrier_hz` (channel offset plus carrier error), complex noise of
    `noise` per component. Returns (bytes, the first sample at or after
    each planted frame's first symbol time)."""
    rng = np.random.default_rng(seed)
    sync = np.asarray(sync_entries, np.int64)
    ns = len(sync) // 2
    n = int(round(seconds * fs))
    n_sym = n * sym_rate // fs + 200
    bi, bq = rng.integers(0, 2, n_sym), rng.integers(0, 2, n_sym)
    keep = np.zeros(n_sym, bool)
    starts = []
    for ft in frame_times(seconds, first_s, spacing_s, sym_rate, ns):
        p = int(ft * sym_rate)
        bi[p:p + ns], bq[p:p + ns] = sync[0::2], sync[1::2]
        keep[p:p + ns] = True
        starts.append(-(-p * fs // sym_rate))
    clear_false_syncs(bi, bq, sync, keep, margin, rng, device)
    # symbols, `span` of them added in front so that every sample has its
    # neighbours; the first symbol k = 0 sits at index `span`
    pre_i, pre_q = rng.integers(0, 2, span), rng.integers(0, 2, span)
    ai = np.concatenate([pre_i, bi]) * 2 - 1
    aq = np.concatenate([pre_q, bq]) * 2 - 1
    sym = torch.complex(torch.as_tensor(ai, dtype=torch.float64),
                        torch.as_tensor(aq, dtype=torch.float64)).to(device)
    # sample t lies r / fs symbols after symbol k0 = t sym_rate // fs, with
    # r = (t sym_rate) mod fs a multiple of g: one row of taps per r / g
    g = math.gcd(sym_rate, fs)
    taps = np.arange(-span, span + 1)
    tab = rrc(np.arange(fs // g)[:, None] * (g / fs) - taps[None, :], rolloff, span)
    tab = torch.as_tensor(tab * amplitude, dtype=torch.float64, device=device)
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.int64, device=device)
        k0 = t * sym_rate // fs + span
        row = tab[torch.remainder(t * sym_rate, fs) // g]
        bb = torch.zeros(e - s, dtype=torch.complex128, device=device)
        for j, k in enumerate(taps):
            bb += sym[k0 + int(k)] * row[:, j]
        del row
        _to_bytes(out, s, e, bb, fs, carrier_hz, noise, gen)
    return out, np.asarray(starts, np.int64)
