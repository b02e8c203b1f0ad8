"""Doppler-shift estimation from an averaged FFT waterfall.

Port of `directdemod_tpu/models/doppler.py` (ref frequency_shift.py):
8192-point windows over the raw byte stream (adc offset -127), magnitude
spectra accumulated in groups of ~1 second, per-group argmax inside the
channel band, 10%-length rolling-mean smoothing, indexed by relative chunk
position. The window FFTs run batched with `torch.fft.fft` on the decoder's
device, a few thousand windows at a time so the working set stays small;
the grouping, argmax and smoothing are host NumPy as in the JAX package.
The track is computed once and cached.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

WINDOW = 2048 * 2 * 2
_WINDOWS_PER_FFT = 4096


def _accumulated_rows(raw_bytes, window: int, every: float,
                      device: torch.device):
    """Group-accumulated |FFT| rows (ref frequency_shift.py:5-44).
    `raw_bytes` is a host uint8 array or a uint8 tensor; the FFTs run on
    `device`."""
    n_win = len(raw_bytes) // (2 * window)
    if n_win == 0:
        return np.empty((0, window))
    rows = []
    acc = np.zeros(window)
    count = 0
    for w0 in range(0, n_win, _WINDOWS_PER_FFT):
        w1 = min(n_win, w0 + _WINDOWS_PER_FFT)
        part = raw_bytes[2 * window * w0: 2 * window * w1]
        b = (part if isinstance(part, torch.Tensor)
             else torch.from_numpy(np.array(part, dtype=np.uint8)))
        b = b.to(device).to(torch.float32)
        iq = torch.complex(b[0::2] - 127.0, b[1::2] - 127.0)
        mags = torch.fft.fft(iq.reshape(w1 - w0, window), dim=-1).abs()
        mags = mags.cpu().numpy()
        for k in range(w0, w1):
            m = mags[k - w0]
            acc = m if count == 0 and k == 0 else acc + m
            count += 1
            if count >= every:
                rows.append(np.log(np.fft.fftshift(acc) / window / every))
                acc = np.zeros(window)
                count = 0
    return np.asarray(rows)


def _rolling_mean(track: np.ndarray, w: int) -> np.ndarray:
    """The reference's edge-handling rolling mean (ref frequency_shift.py:46-57)."""
    n = len(track)
    out = np.empty(n)
    for i in range(n):
        if i < w // 2:
            out[i] = np.mean(track[0:w])
        elif i > n - w // 2:
            out[i] = np.mean(track[-(w // 2):])
        else:
            out[i] = np.mean(track[i - w // 2: i - w // 2 + w])
    return out


def find_shift(raw_bytes, samp_rate, center_freq, channel_freq, bandwidth,
               device=None) -> np.ndarray:
    """Smoothed frequency-offset track in Hz over relative capture time
    (ref frequency_shift.py:60-126); the FFTs run on `device` (the port's
    device rule, `device.resolve`)."""
    device = resolve(device)
    window = WINDOW
    xf = np.fft.fftshift(np.fft.fftfreq(window, 1.0 / samp_rate))
    df = xf[1] - xf[0]
    every = (len(raw_bytes) / (samp_rate * 2.0)) * 8192.0 / window
    rows = _accumulated_rows(raw_bytes, window, every, device)
    center = (samp_rate / 2 + (channel_freq - center_freq)) / df
    b0 = int(center - bandwidth / (2 * df))
    b1 = int(center + bandwidth / (2 * df))
    band = rows[:, b0:b1]
    band = band - np.min(band, axis=-1, keepdims=True)
    track = np.argmax(band, axis=-1) - bandwidth / (2 * df)
    w = int(len(track) * 0.1)
    if w >= 1:
        track = _rolling_mean(track, w)
    return np.asarray(track) * df


class DopplerTracker:
    """Cached per-chunk Doppler correction (ref frequency_shift.py:128-149)."""

    def __init__(self, raw_bytes, samp_rate, center_freq, channel_freq,
                 bandwidth=20000, device=None):
        self._args = (raw_bytes, samp_rate, center_freq, channel_freq, bandwidth,
                      device)
        self._track = None

    @property
    def track(self) -> np.ndarray:
        if self._track is None:
            self._track = find_shift(*self._args)
        return self._track

    def correct(self, chunk_number: int, chunk_count: int) -> float:
        """Shift (Hz) for chunk k of n, nearest-track-row lookup
        (ref frequency_shift.py:128-144)."""
        shift = self.track
        position = chunk_number / chunk_count
        step = 1.0 / (len(shift) - 1)
        x1 = int(np.floor(position / step + step / 2))
        return float(shift[min(x1, len(shift) - 1)])
