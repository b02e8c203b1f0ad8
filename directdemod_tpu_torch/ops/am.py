"""AM envelope demodulation.

Port of `directdemod_tpu/ops/am.py:16-67`: ``abs(hilbert(sig))``, applied
per fixed-size block with no carried state (the reference's chunked AM
demod, block = 240000); the blockwise semantics is part of the numeric
contract. Full blocks run as one batched FFT, the remainder as its own.
`envelope_lowpass` is the reference's other AM demod, a low-pass over the
magnitude with carried state.
"""
from __future__ import annotations

import torch


def analytic(x: torch.Tensor) -> torch.Tensor:
    """scipy.signal.hilbert for a real signal along the last axis."""
    n = x.shape[-1]
    X = torch.fft.fft(x, dim=-1)
    h = torch.zeros(n, dtype=x.dtype, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(X * h, dim=-1)


def envelope(x: torch.Tensor) -> torch.Tensor:
    """|hilbert(x)| along the last axis."""
    return analytic(x).abs()


def envelope_lowpass(x: torch.Tensor, fs: float, cutoff: float, state=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """AM demodulation by low-pass filtering |x| (`demod_amFLT`, ref
    demod_am.py:35-62): a 6th-order Butterworth low-pass over the
    magnitude, its state carried for chunked streams (None: the unit-step
    state, in x's real precision). Returns (envelope, new_state)."""
    from .iir import IirFilter
    filt = IirFilter.design_butter(fs, cutoff, order=6, kind="lowpass")
    if state is None:
        state = filt.initial_state_step(
            torch.float64 if x.dtype in (torch.float64, torch.complex128)
            else torch.float32, x.device)
    return filt.apply(x.abs(), state)


def envelope_blocked(x: torch.Tensor, block: int) -> torch.Tensor:
    """Envelope per `block`-sample block along the last axis, no
    cross-block state. Leading axes are channels, each row blocked as a
    1-D call blocks it: all rows' full blocks in one batched FFT, each
    row's remainder an FFT of its own (a batch of rows rounds an FFT of
    some lengths otherwise than one row does)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    nfull = n // block
    out = []
    if nfull:
        full = x[..., : nfull * block].reshape(lead + (nfull, block))
        out.append(envelope(full).reshape(lead + (nfull * block,)))
    if n - nfull * block:
        rest = x[..., nfull * block:]
        out.append(envelope(rest) if not lead else torch.stack(
            [envelope(r) for r in rest.reshape(-1, rest.shape[-1])]).reshape(rest.shape))
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)
