"""Seeded FUNcube-1 BPSK pass as 8-bit IQ bytes, made on the device.

Frozen copy of `chip_smoke.py:685-790` (`_psk_bytes`, `funcube_frames`,
`clear_false_syncs`, `synth_funcube_bytes`), every signal parameter taken
from the configuration and the workload, and the filler's clearing made to
end on every seed (`clear_false_syncs`).
"""
from __future__ import annotations

import numpy as np
import torch


def frame_times(seconds: float, first_s: float, spacing_s: float,
                bit_rate: float, sync_bits: int) -> list:
    """Planted frame times: every `spacing_s` from `first_s` while the sync
    and 0.2 s after it fit."""
    out, ft = [], first_s
    while ft + sync_bits / bit_rate + 0.2 < seconds:
        out.append(ft)
        ft += spacing_s
    return out


def clear_false_syncs(bits: np.ndarray, sync: np.ndarray, keep: np.ndarray,
                      margin: int, rng: np.random.Generator) -> None:
    """Flip filler bits until no window of len(sync) bits clear of the
    planted frames (`keep`) lies within `margin` bits of the sync or of its
    complement. The detector fires on near-matches, which random filler
    produces about once a minute; the benchmark holds the decoder to the
    planted frames only. Unlike the source, the bit flipped is drawn from
    `rng` among those that move the window away: the middle one can undo an
    overlapping window's flip pass after pass."""
    L = len(sync)
    # windows that overlap a planted frame fire next to it, in its cluster
    touches = np.convolve(keep, np.ones(L, int))[L - 1:len(bits)] > 0
    for _ in range(256):
        win = np.lib.stride_tricks.sliding_window_view(bits, L)
        d = np.count_nonzero(win != sync, axis=1)
        bad = np.flatnonzero(((d < margin) | (d > L - margin)) & ~touches)
        if len(bad) == 0:
            return
        for w in bad:
            diff = bits[w:w + L] != sync
            dw = int(diff.sum())
            if margin <= dw <= L - margin:
                continue                # an earlier flip fixed it
            j = np.flatnonzero(~diff if dw < margin else diff)
            bits[w + j[rng.integers(len(j))]] ^= 1
    raise RuntimeError("could not clear the filler of false syncs")


def _to_bytes(out: torch.Tensor, s: int, e: int, bb: torch.Tensor, fs: int,
              freq_hz: int, noise: float, gen: torch.Generator) -> None:
    """Samples [s, e) of the complex baseband `bb` moved to +freq_hz, plus
    noise, as uint8 IQ bytes at x + 127.5 into `out`. The carrier phase
    takes (freq * t) mod fs in exact integers."""
    dev = bb.device
    t = torch.arange(s, e, dtype=torch.int64, device=dev)
    ph = (2 * np.pi / fs) * torch.remainder(freq_hz * t, fs).double()
    x = bb * torch.polar(torch.ones_like(ph), ph)
    for k, part in enumerate((x.real, x.imag)):
        noisy = part + noise * torch.randn(e - s, dtype=torch.float64,
                                           device=dev, generator=gen)
        out[2 * s + k: 2 * e: 2] = torch.clamp(torch.round(noisy + 127.5),
                                               0, 255).to(torch.uint8)


def pass_bytes(seconds: float, fs: int, bit_rate: int, sync: str,
               first_s: float, spacing_s: float, amplitude: float,
               carrier_hz: int, noise: float, clear_margin: int, device,
               seed: int, chunk: int = 1 << 25) -> tuple[torch.Tensor, np.ndarray]:
    """BPSK capture of `seconds` as interleaved uint8 IQ on `device`:
    `bit_rate` random bits (rectangular, so spread over the decoder's
    symbols) at +-`amplitude`, the frame `sync` planted at `frame_times`,
    filler cleared of near-syncs, on `carrier_hz` (channel offset plus
    carrier error), complex noise of `noise` per component. Returns
    (bytes, first sample of each planted frame)."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * fs))
    bits = rng.integers(0, 2, n * bit_rate // fs + 40)
    sb = np.asarray([int(c) for c in sync])
    keep = np.zeros(len(bits), bool)
    starts = []
    for ft in frame_times(seconds, first_s, spacing_s, bit_rate, len(sb)):
        p = int(ft * bit_rate)
        bits[p:p + len(sb)] = sb
        keep[p:p + len(sb)] = True
        starts.append(-(-p * fs // bit_rate))
    clear_false_syncs(bits, sb, keep, clear_margin, rng)
    lev = torch.as_tensor(bits * 2 - 1, dtype=torch.float64, device=device) * amplitude
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.int64, device=device)
        bb = lev[t * bit_rate // fs].to(torch.complex128)
        _to_bytes(out, s, e, bb, fs, carrier_hz, noise, gen)
    return out, np.asarray(starts, np.int64)
