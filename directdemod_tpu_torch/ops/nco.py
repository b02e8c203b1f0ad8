"""Numerically-controlled oscillator (frequency shifting) for long streams.

Port of `directdemod_tpu/ops/nco.py`: ``x[n] *= exp(-2j*pi*f*(g0+n)/Fs)``
with ``g0`` the index of the first sample. Indices reach 1e9+, so a single
float32 phase ramp would lose ~0.1 rad by the end of a 20 M-sample block:
the phase is anchored in float64 on the host every `SUBBLOCK` samples and
the device extends each anchor with a short local float32 ramp, bounding the
phase error at ~1e-4 rad at any stream position.
"""
from __future__ import annotations

import numpy as np
import torch

SUBBLOCK = 8192


def phase_anchors(freq: float, fs: float, start: int, n: int,
                  sub: int = SUBBLOCK, dtype=np.float32) -> np.ndarray:
    """Host float64: phase (mod 2pi) at the start of each sub-block."""
    nsub = -(-n // sub)
    idx = start + sub * np.arange(nsub, dtype=np.float64)
    ph = (-2.0 * np.pi * float(freq) / float(fs)) * idx
    return np.mod(ph, 2.0 * np.pi).astype(dtype)


def _osc_apply(x: torch.Tensor, ph: torch.Tensor) -> torch.Tensor:
    """x * exp(j ph), the oscillator in x's complex type."""
    return x * torch.polar(torch.ones_like(ph), ph).to(x.dtype)


def _ramp_phase(anchors: torch.Tensor, omega: float, n: int,
                sub: int = SUBBLOCK) -> torch.Tensor:
    ramp = torch.tensor(omega, dtype=anchors.dtype, device=anchors.device) \
        * torch.arange(sub, dtype=anchors.dtype, device=anchors.device)
    return (anchors[:, None] + ramp[None, :]).reshape(-1)[:n]


def mix(x: torch.Tensor, omega: float, anchors: torch.Tensor,
        sub: int = SUBBLOCK) -> torch.Tensor:
    """Multiply x by exp(j*(anchor_b + omega*r)) for local offset r within
    sub-block b. `omega` is the per-sample phase increment -2*pi*f/fs;
    `anchors` (on x's device) come from `phase_anchors` and set the
    precision."""
    return _osc_apply(x, _ramp_phase(anchors, omega, int(x.shape[0]), sub))


def mix_array_freq(x: torch.Tensor, freqs: np.ndarray, fs: float,
                   start: int = 0) -> torch.Tensor:
    """Per-sample frequency offsets (Doppler ramps), chunk-local indices.

    The phase is the *instantaneous* frequency times absolute time, not an
    integrated phase, as in the reference formula. `freqs` is host-side (the
    Doppler track is computed on the host); the first frequency's ramp rides
    the float64-anchor mechanism of `phase_anchors`, and only the small
    per-sample delta runs in float32.
    """
    n = int(x.shape[0])
    dev = x.device
    freqs_np = np.asarray(freqs, dtype=np.float64).reshape(-1)
    base = float(freqs_np[0])
    delta = torch.as_tensor(freqs_np - base, dtype=torch.float32, device=dev)
    idx_local = torch.arange(n, dtype=torch.float32, device=dev)
    anchors = torch.as_tensor(phase_anchors(base, fs, start, n), device=dev)
    omega = float(np.float32(-2.0 * np.pi * base / fs))
    ph_base = _ramp_phase(anchors, omega, n)
    ph_delta = (-2.0 * np.pi / fs) * delta * (idx_local + float(start))
    return _osc_apply(x, ph_base + ph_delta)
