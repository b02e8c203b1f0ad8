"""Cross-correlation and sync-pattern search.

Port of `directdemod_tpu/ops/correlate.py:23-150`:
  * `scipy.signal.correlate(h, n, mode='same')` for sync search;
  * the normalized correlator ``cor / sqrt(moving_energy * needle_energy)``;
  * the APT sync-train needles.
All correlations run as FFTs (the needles are 560..113k samples long).
"""
from __future__ import annotations

import numpy as np
import torch


def fft_len(n: int) -> int:
    """Smallest 5-smooth length (2^a 3^b 5^c) >= n: a fast FFT size for
    cuFFT and pocketfft alike."""
    best = 1 << max(0, n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            x = p35
            while x < n:
                x *= 2
            best = min(best, x)
            p35 *= 3
        p5 *= 5
    return best


def fft_convolve_full(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Full linear convolution over the last axis via FFT."""
    n = x.shape[-1] + w.shape[-1] - 1
    m = fft_len(n)
    if x.is_complex() or w.is_complex():
        return torch.fft.ifft(torch.fft.fft(x, n=m) * torch.fft.fft(w, n=m))[..., :n]
    return torch.fft.irfft(torch.fft.rfft(x, n=m) * torch.fft.rfft(w, n=m),
                           n=m)[..., :n]


def convolve_same_fft(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """np.convolve(x, w, 'same') via FFT."""
    start = (w.shape[-1] - 1) // 2
    return fft_convolve_full(x, w)[..., start:start + x.shape[-1]]


def correlate_same(x: torch.Tensor, needle: torch.Tensor) -> torch.Tensor:
    """scipy.signal.correlate(x, needle, mode='same')."""
    w = needle.flip(-1)
    return convolve_same_fft(x, w.conj() if w.is_complex() else w)


def moving_energy(x: torch.Tensor, wlen: int) -> torch.Tensor:
    """np.convolve(x*x, ones(wlen), 'same')."""
    return convolve_same_fft(x * x, torch.ones(wlen, dtype=x.dtype,
                                               device=x.device))


def norm_correlate(haystack: torch.Tensor, needle: torch.Tensor) -> torch.Tensor:
    """``correlate(h, n, 'same') / sqrt(moving_energy(h) * sum(n^2))`` over
    the last axis of `haystack` (leading axes are batch axes)."""
    cor = correlate_same(haystack, needle)
    sums = moving_energy(haystack, needle.shape[-1])
    return cor / torch.sqrt(sums * torch.sum(needle * needle))


def norm_correlate_multi(haystack: torch.Tensor,
                         needles: torch.Tensor) -> torch.Tensor:
    """`norm_correlate` of a haystack, (n,) or (C, n), against a (k, L)
    stack of equal-length real needles, sharing the haystack FFT and the
    energy term. Returns (k, n), or (C, k, n): a row at a time, as a batch
    of rows rounds an FFT of some lengths otherwise than one row does."""
    if haystack.is_complex() or needles.is_complex():
        raise ValueError("norm_correlate_multi is real-only")
    if haystack.dim() > 1:
        rows = haystack.reshape(-1, haystack.shape[-1])
        return torch.stack([norm_correlate_multi(h, needles) for h in rows]
                           ).reshape(haystack.shape[:-1] + (needles.shape[0], -1))
    k_len = needles.shape[-1]
    n = haystack.shape[-1] + k_len - 1
    m = fft_len(n)
    X = torch.fft.rfft(haystack, n=m)
    W = torch.fft.rfft(needles.flip(-1), n=m)
    full = torch.fft.irfft(X[None, :] * W, n=m)[..., :n]
    start = (k_len - 1) // 2
    cor = full[..., start:start + haystack.shape[-1]]
    sums = moving_energy(haystack, k_len)
    energy = torch.sum(needles * needles, dim=-1, keepdim=True)
    return cor / torch.sqrt(sums[None, :] * energy)


def norm_correlate_multi_blocked(haystack: torch.Tensor,
                                 needles: torch.Tensor,
                                 blk: int = 1 << 17) -> torch.Tensor:
    """`norm_correlate_multi` by overlap-save: `blk`-wide frames with
    needle-length halos, every FFT batched over frames (and over the
    channels of a (C, n) haystack, each row framed as a 1-D call frames
    it). The reference frames this way because one multi-million-point FFT
    was slow on its device; the port keeps the framing so both compute the
    same sums in the same blocks, and it bounds the FFT scratch."""
    if haystack.is_complex() or needles.is_complex():
        raise ValueError("norm_correlate_multi_blocked is real-only")
    n = haystack.shape[-1]
    lead = haystack.shape[:-1]
    L = needles.shape[-1]
    if n <= 2 * blk:
        return norm_correlate_multi(haystack, needles)
    halo_l, halo_r = L // 2, (L - 1) // 2
    nb = -(-n // blk)
    ep = torch.nn.functional.pad(haystack, (halo_l, nb * blk - n + halo_r))
    frames = ep.unfold(-1, blk + halo_l + halo_r, blk)     # (..., nb, blk + L - 1)
    m = fft_len(blk + 2 * (L - 1))
    X = torch.fft.rfft(frames, n=m)
    X2 = torch.fft.rfft(frames * frames, n=m)
    W = torch.fft.rfft(needles.flip(-1), n=m)               # (k, M)
    Wo = torch.fft.rfft(torch.ones(L, dtype=haystack.dtype,
                                   device=haystack.device), n=m)
    cor_f = torch.fft.irfft(X.unsqueeze(-3) * W[:, None, :], n=m)
    en_f = torch.fft.irfft(X2 * Wo, n=m)
    # frame-local correlate-'same' output for global p = i*blk + p' sits at
    # conv_full(frame, w_rev)[p' + L - 1]
    cor = cor_f[..., L - 1: L - 1 + blk].reshape(lead + (needles.shape[0], nb * blk))
    sums = en_f[..., L - 1: L - 1 + blk].reshape(lead + (1, nb * blk))
    energy = torch.sum(needles * needles, dim=-1, keepdim=True)
    return cor[..., :n] / torch.sqrt(sums[..., :n] * energy)


def apt_needle(sync_bits, samp_rate: float, t_bit: float,
               positive: bool = True) -> np.ndarray:
    """APT sync needle at `samp_rate`: each bit repeated
    round(samp_rate * t_bit) times; the positive form maps {0,1} ->
    {11,244}/255, the signed form subtracts 0.5."""
    rep = int(round(samp_rate * t_bit))
    bits = np.repeat(np.asarray(sync_bits, dtype=np.float64), rep)
    if positive:
        return (bits * 233.0 + 11.0) / 255.0
    return bits - 0.5
