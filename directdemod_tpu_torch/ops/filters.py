"""Filter facade: the reference's filter-class surface on the port.

Port of `directdemod_tpu/ops/filters.py` (ref filters.py:15-326). Each
factory returns either FIR taps (consumed by `Stream.filter` /
`stream.pipeline.Filter`) or an `IirFilter`. The reference's
`storeState`/`zeroPhase` modes map onto the pipeline stages: stateful ==
`Filter`/`Butter` with carried history, zeroPhase ==
`FilterZeroPhase`/`ButterZeroPhase`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as K
from . import design, fir
from .iir import IirFilter


def rolling_average(n: int = 3) -> np.ndarray:
    """Boxcar FIR (ref filters.py:95-114)."""
    return design.rolling_average(n)


def blackman_harris(n: int) -> np.ndarray:
    """4-term Blackman-Harris window FIR (ref filters.py:120-139)."""
    return design.blackmanharris(n)


def hamming(n: int) -> np.ndarray:
    """Hamming window FIR (ref filters.py:180-199)."""
    return design.hamming(n)


def gaussian(n: int, sigma: float) -> np.ndarray:
    """Gaussian window FIR (ref filters.py:205-226)."""
    return design.gaussian(n, sigma)


def remez(fs: float, bands, gains, ntaps: int = 128) -> np.ndarray:
    """Multiband equiripple FIR (ref filters.py:279-314), same band/gain
    validation."""
    if len(bands) == 0:
        raise ValueError("at least one band must be given")
    if bands[-1][1] >= fs / 2:
        raise ValueError("last band must end before Fs/2")
    flat = [edge for band in bands for edge in band]
    if len(flat) != 2 * len(gains):
        raise ValueError("invalid bands/gains values")
    return design.remez(ntaps, flat, gains, fs=fs)


def butter(fs, cutoff_a, cutoff_b=None, n: int = 6,
           kind: int = K.FLT_LP) -> IirFilter:
    """Butterworth via FLT_* kind constants (ref filters.py:232-273)."""
    kinds = {K.FLT_LP: "lowpass", K.FLT_HP: "highpass",
             K.FLT_BP: "bandpass", K.FLT_BS: "bandstop"}
    if kind in (K.FLT_BP, K.FLT_BS) and cutoff_b is None:
        raise ValueError("cutoff_b must be given for bandpass/bandstop")
    if kind not in kinds:
        raise ValueError("invalid filter type")
    return IirFilter.design_butter(fs, cutoff_a, cutoff_b, order=n,
                                   kind=kinds[kind])


def convolve_same(sig, taps) -> torch.Tensor:
    """The 'blackmanHarrisConv' direct same-mode convolution variant
    (ref filters.py:145-174); tensors stay on their device."""
    sig = torch.as_tensor(sig)
    return fir.convolve_same(sig, torch.as_tensor(taps, device=sig.device))


def median_filter(sig, n: int = 5) -> torch.Tensor:
    """Sliding-window median, scipy.signal.medfilt semantics (zero padding
    at the edges; ref filters.py:322-326): one sort over the `n` shifted
    copies. An odd `n` has one middle value; for an even `n` the two middle
    values are averaged, as `jnp.median` does."""
    x = torch.as_tensor(sig)
    pad = n // 2
    xp = torch.nn.functional.pad(x, (pad, pad))
    win = torch.stack([xp[i:i + x.shape[0]] for i in range(n)], dim=-1)
    srt = win.sort(dim=-1).values
    return (srt[..., (n - 1) // 2] + srt[..., n // 2]) / 2 if n % 2 == 0 \
        else srt[..., n // 2]
