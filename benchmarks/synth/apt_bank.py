"""Seeded capture of several NOAA APT passes at once, as 8-bit IQ bytes,
made on the device.

The `noaa_apt_3sat` deployment: one 2.048 Msps recording centred between
the APT downlinks, each satellite's pass at its own offset
(`cfg["channels"]`). Each channel is a pass of `synth.apt` (`picture`, the
KLM section 4.2 line with its telemetry frame) drawn from a seed of its
own, derived from the run's seed, with its lines starting at a seeded
phase, since the satellites' line clocks are independent; its carrier has
the channel's amplitude. The channels' carriers are summed, complex noise
of `noise` a component is added once, and the sum is quantized as
`synth.apt.pass_bytes` quantizes one pass (x90 + 127.5). The amplitudes
sum to at most 1, so nothing clips.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks.synth import apt as synth


def channel_seeds(seed: int, channels: int) -> list:
    """The seed of each channel's picture, telemetry and line phase,
    derived from the run's seed."""
    return [int(np.random.SeedSequence([seed, c]).generate_state(1, np.uint64)[0]
                >> np.uint64(1)) for c in range(channels)]


def pass_bytes(n_lines: int, cfg, noise: float, device, seed: int,
               chunk: int = 1 << 24) -> tuple[torch.Tensor, list]:
    """A capture of `n_lines` lines and a quarter second (as
    `synth.apt.pass_bytes`) holding every channel of `cfg["channels"]` for
    its whole length, as interleaved uint8 IQ on `device`. Returns (bytes,
    [(the channel's word lines, its line phase in seconds)] a channel):
    channel c's sample at time t carries the word of its lines at
    t + phase."""
    fs = int(cfg["sample_rate"])
    word_rate, sub_hz = float(cfg["word_rate"]), float(cfg["subcarrier_hz"])
    dev_hz = float(cfg["deviation_hz"])
    chans = cfg["channels"]
    if sum(float(ch["amplitude"]) for ch in chans) > 1.0:
        raise ValueError("the channels' amplitudes sum above 1: the bytes would clip")
    n = int((n_lines * 0.5 + 0.25) * fs)
    planted, words = [], []
    for ch, s in zip(chans, channel_seeds(seed, len(chans))):
        lines = synth.picture(n_lines + 2, cfg, s)
        phase = float(np.random.default_rng(s).uniform(0.0, 0.5))
        planted.append((lines, phase))
        words.append(torch.as_tensor(lines.reshape(-1), dtype=torch.float64,
                                     device=device))
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phase0 = [torch.zeros((), dtype=torch.float64, device=device) for _ in chans]
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.float64, device=device) / fs
        re = torch.zeros(e - s, dtype=torch.float64, device=device)
        im = torch.zeros_like(re)
        for c, ch in enumerate(chans):
            w, tc = words[c], t + planted[c][1]     # the satellite's clock
            widx = torch.clamp((tc * word_rate).long(), max=w.shape[0] - 1)
            baseband = (0.05 + 0.9 * w[widx] / 255.0) * torch.cos(2 * np.pi * sub_hz * tc)
            dphi = 2 * np.pi * (float(ch["offset_hz"]) / fs) \
                + 2 * np.pi * dev_hz * baseband / fs
            phase = phase0[c] + torch.cumsum(dphi, 0)
            phase0[c] = torch.remainder(phase[-1], 2 * np.pi)
            amp = float(ch["amplitude"])
            re += amp * torch.cos(phase)
            im += amp * torch.sin(phase)
            del tc, widx, baseband, dphi, phase
        for k, part in enumerate((re, im)):
            noisy = part + noise * torch.randn(e - s, dtype=torch.float64,
                                               device=device, generator=gen)
            out[2 * s + k: 2 * e: 2] = torch.clamp(
                torch.round(noisy * 90.0 + 127.5), 0, 255).to(torch.uint8)
    return out, planted
