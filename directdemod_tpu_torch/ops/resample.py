"""Rate conversion: strided decimation with phase carry, and FFT resampling.

Port of `directdemod_tpu/ops/resample.py:22-94`:
  * `comm.bwLim(strict=False)`: integer-stride pick ``x[off::J]`` with the
    phase carried across blocks so kept samples sit on global indices that
    are multiples of J; the rate is ``int(fs / J)``, truncation included.
  * `comm.bwLim(strict=True)` and the per-line pixel resample:
    ``scipy.signal.resample`` Fourier resampling, bin for bin, on torch.fft
    (cuFFT takes any length, so no chirp-z detour is needed).
"""
from __future__ import annotations

import torch


def decim_params(fs: int, target: int) -> tuple[int, int]:
    """(stride J, new integer rate) for bwLim."""
    if fs < target:
        raise ValueError("target rate above source rate")
    j = int(fs // target)
    return j, int(fs / j)


def decim_phase(global_start: int, stride: int) -> int:
    """Decimator phase of a block starting at `global_start`: kept samples
    are the global indices = 0 (mod stride)."""
    return (-global_start) % stride


def decim_count(n: int, off: int, stride: int) -> int:
    """Number of kept samples in a block of length n with phase off."""
    return -(-(n - off) // stride) if n > off else 0


def decimate(x: torch.Tensor, off: int, stride: int, out_len: int) -> torch.Tensor:
    """x[off::stride] truncated to `out_len` samples."""
    return x[off::stride][:out_len]


def fft_resample(x: torch.Tensor, num: int) -> torch.Tensor:
    """scipy.signal.resample along the last axis, including scipy's
    half-Nyquist-bin rules in both directions."""
    n = x.shape[-1]
    if num == n:
        return x
    scale = float(num) / float(n)
    nkeep = min(num, n)
    nyq = nkeep // 2 + 1
    if not x.is_complex():
        X = torch.fft.rfft(x, dim=-1)
        Y = X.new_zeros(x.shape[:-1] + (num // 2 + 1,))
        Y[..., :nyq] = X[..., :nyq]
        if nkeep % 2 == 0:
            Y[..., nkeep // 2] *= 2.0 if num < n else 0.5
        return torch.fft.irfft(Y, n=num, dim=-1) * scale
    X = torch.fft.fft(x, dim=-1)
    Y = X.new_zeros(x.shape[:-1] + (num,))
    Y[..., :nyq] = X[..., :nyq]
    if nkeep > 2:
        Y[..., nyq - nkeep:] = X[..., nyq - nkeep:]
    if nkeep % 2 == 0:
        half = nkeep // 2
        if num < n:
            # fold the input's -N/2 bin into the output's +N/2 bin
            Y[..., half] += X[..., n - half]
        else:
            Y[..., half] *= 0.5
            Y[..., num - half] = Y[..., half]
    return torch.fft.ifft(Y, dim=-1) * scale
