"""IIR (Butterworth) filtering as block-parallel second-order sections.

Port of `directdemod_tpu/ops/iir.py:40-227`: scipy `lfilter(b, a, x, zi)`
through a cascade of biquads, and the `filtfilt` zero-phase mode. Each
biquad is evaluated with the exact block decomposition of its DF2T state
space

    z[t] = A z[t-1] + B x[t],   y[t] = C z[t-1] + D x[t]      (A is 2x2)

For a block of length L with incoming state s:

    y[t] = (C A^t) s + (h * x)[t]        zero-input response + causal conv
    s'   = A^L s + sum_t A^(L-1-t) B x[t]

so the per-sample work is a batched FFT convolution with h[:L] plus two
skinny matmuls against fp64 constants. Only the 2-vector block-boundary
states are sequential; the reference walks them with a `lax.scan`, the port
with a log-depth doubling scan (torch has no scan, and a Python loop would
launch ~N/L tiny kernels per section).

The constants are built once a process: the host set of a (design, block
length) by `_segment_constants`, every shorter block and ragged tail as
exact slices of it (h[:p], S[:p], G[L-p:], and A^p by `matrix_power`, bit
for bit `_segment_constants(..., p)`), and their copies on each device in
each dtype kept, so a warm `apply` or `zero_phase` copies nothing to the
device and never waits for it. Each cache drops its least recently used
set past `_CACHE_SETS`. A build is the range `iir.constants`; while a
profiler records, the tally (`models.stages.session_counts`) counts
`iir.constants.built` (sets made) and `iir.constants.reused` (lookups
served from the cache).
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..models import stages
from . import design
from .correlate import fft_len

# sets each cache keeps (least recently used dropped first)
_CACHE_SETS = 64
# host fp64 (h, S, G) of each section, by (SOS bytes, block length)
_host_sets: OrderedDict = OrderedDict()
# device sets, by (SOS bytes, block, L, tail p, dtype, device)
_device_sets: OrderedDict = OrderedDict()
# unit-step initial states, by (SOS bytes, dtype, device)
_step_states: OrderedDict = OrderedDict()
# decoders in threads share the caches (a device set's build looks up its
# host set, so the lock is reentrant)
_cache_lock = threading.RLock()


def _biquad_state_space(section):
    """DF2T state-space (A, B, C, D) for one SOS row [b0 b1 b2 1 a1 a2]."""
    b0, b1, b2, a0, a1, a2 = (float(v) for v in section)
    b0, b1, b2, a1, a2 = b0 / a0, b1 / a0, b2 / a0, a1 / a0, a2 / a0
    A = np.array([[-a1, 1.0], [-a2, 0.0]])
    B = np.array([b1 - a1 * b0, b2 - a2 * b0])
    C = np.array([1.0, 0.0])
    return A, B, C, b0


def _segment_constants(A, B, C, D, L):
    """(h[:L], S rows C A^t, G rows A^(L-1-t) B, A^L)."""
    S = np.empty((L, 2))
    h = np.empty(L)
    h[0] = D
    v = C.copy()
    for t in range(L):
        S[t] = v
        if t + 1 < L:
            h[t + 1] = v @ B
        v = v @ A
    G = np.empty((L, 2))
    w = B.copy()
    for t in range(L - 1, -1, -1):
        G[t] = w
        w = A @ w
    return h, S, G, np.linalg.matrix_power(A, L)


def _slice_constants(hSG, A, p):
    """`_segment_constants(A, B, C, D, p)` from the (h, S, G) of a longer
    block, p <= len(h): the same recurrences, so exact slices."""
    h, S, G = hSG
    return h[:p], S[:p], G[len(h) - p:], np.linalg.matrix_power(A, p)


def _cached(cache: OrderedDict, key, make):
    """(cache[key], False), or (make(), True) kept under `key` on a miss,
    the least recently used entry dropped past `_CACHE_SETS`."""
    with _cache_lock:
        if key in cache:
            cache.move_to_end(key)
            return cache[key], False
        cache[key] = value = make()
        if len(cache) > _CACHE_SETS:
            cache.popitem(last=False)
        return value, True


def _host_set(sos: np.ndarray, block: int) -> list:
    """Each section's host (h, S, G) for `block`-sample blocks, built
    once a process for each (design, block)."""
    return _cached(_host_sets, (sos.tobytes(), block), lambda: [
        _segment_constants(*_biquad_state_space(s), block)[:3] for s in sos])[0]


def clear_constants() -> None:
    """Drop every cached set, on the host and on the devices."""
    with _cache_lock:
        _host_sets.clear()
        _device_sets.clear()
        _step_states.clear()


def _block_states(z0: torch.Tensor, f: torch.Tensor, M: torch.Tensor
                  ) -> torch.Tensor:
    """States entering each block: s[0] = z0, s[i+1] = M s[i] + f[i], for
    i < len(f); returns all len(f) + 1 of them (row vectors). Hillis-Steele
    doubling: after the round with shift d, row i holds the sum over its
    last 2d inputs, each weighted by the matching power of M."""
    g = torch.cat([z0[None, :], f])
    P = M
    d = 1
    while d < g.shape[0]:
        g = torch.cat([g[:d], g[d:] + g[:-d] @ P.T])
        P = P @ P
        d *= 2
    return g


class IirFilter:
    """A cascade of second-order sections (rows of a scipy-style SOS
    matrix) over real signals. State is a flat (2 * n_sections,) vector."""

    def __init__(self, sos, block: int = 4096):
        self.sos = np.asarray(sos, dtype=np.float64).reshape(-1, 6)
        self.block = int(block)

    @staticmethod
    def design_butter(fs, cutoff_a, cutoff_b=None, order=6, kind="lowpass",
                      block=4096) -> "IirFilter":
        """Butterworth design (the reference's filters.butter constructor)."""
        if kind in ("lowpass", "highpass"):
            wn = cutoff_a / (0.5 * fs)
        else:
            wn = [cutoff_a / (0.5 * fs), cutoff_b / (0.5 * fs)]
        return IirFilter(design.butter_sos(order, wn, btype=kind), block)

    @staticmethod
    def from_ba(b, a, block: int = 4096) -> "IirFilter":
        """One section from (b, a) polynomials of order at most 2 (higher
        orders go through `design_butter`'s second-order sections)."""
        if max(len(b), len(a)) > 3:
            raise ValueError("use design_butter / SOS for order > 2")
        b = np.pad(np.asarray(b, dtype=np.float64), (0, 3 - len(b)))
        a = np.pad(np.asarray(a, dtype=np.float64), (0, 3 - len(a)))
        return IirFilter(np.concatenate([b, a])[None, :], block)

    @property
    def n_sections(self) -> int:
        return self.sos.shape[0]

    def ba(self) -> tuple[np.ndarray, np.ndarray]:
        """Flat (b, a) polynomials."""
        b, a = np.array([1.0]), np.array([1.0])
        for s in self.sos:
            b = np.convolve(b, s[:3])
            a = np.convolve(a, s[3:])
        return b, a

    def initial_state_step(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Raw `lfilter_zi` seed (the steady state of a unit step), per
        section scaled by the DC gain of the sections upstream of it."""
        return self._step_state(dtype, device).clone()

    def _step_state(self, dtype, device) -> torch.Tensor:
        """`initial_state_step`'s tensor, made once a process for each
        (design, dtype, device); not to be written to."""
        def make():
            states = []
            gain_in = 1.0
            for s in self.sos:
                states.append(design.lfilter_zi(s[:3], s[3:]) * gain_in)
                gain_in *= float(np.sum(s[:3]) / np.sum(s[3:]))
            return torch.as_tensor(np.concatenate(states), dtype=dtype, device=device)
        return _cached(_step_states, (self.sos.tobytes(), dtype, device), make)[0]

    def initial_state_zero(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The all-zero state (a filter at rest)."""
        return torch.zeros(2 * self.n_sections, dtype=dtype, device=device)

    def _constants(self, L: int, p: int, dtype, device) -> list:
        """Each section's (h[:L], S[:L], G for L, A^L), and (G for p, A^p)
        after them where p < L, as `dtype` tensors on `device`, for
        L-sample blocks of which the last holds p: copies of slices of the
        design's `block` set, made once a process for each (L, p, dtype,
        device)."""
        def t(a):
            return torch.tensor(a, dtype=dtype, device=device)

        def make():
            out = []
            with stages.span("iir.constants"):
                for s, hSG in zip(self.sos, _host_set(self.sos, self.block)):
                    A = _biquad_state_space(s)[0]
                    tail = () if p == L else _slice_constants(hSG, A, p)[2:]
                    out.append(tuple(t(a) for a in _slice_constants(hSG, A, L) + tail))
            return out
        consts, made = _cached(_device_sets, (self.sos.tobytes(), self.block,
                                              L, p, dtype, device), make)
        stages.count("iir.constants.built" if made else "iir.constants.reused", 1)
        return consts

    def _apply_section(self, x, z, consts, np_last):
        h, S, G, AL = consts[:4]
        L = h.shape[0]
        n = x.shape[0]
        nb = -(-n // L)
        m = fft_len(2 * L - 1)
        xb = torch.nn.functional.pad(x, (0, nb * L - n)).reshape(nb, L)
        f = xb @ G                                        # (nb, 2)
        s_all = _block_states(z.to(x.dtype), f, AL)       # (nb + 1, 2)
        s_hist = s_all[:nb]
        conv = torch.fft.irfft(torch.fft.rfft(xb, n=m) * torch.fft.rfft(h, n=m),
                               n=m)[:, :L]
        y = (conv + s_hist @ S.T).reshape(-1)[:n]
        if np_last == L:
            z_out = s_all[nb]
        else:
            Gp, ALp = consts[4:]
            z_out = s_hist[-1] @ ALp.T + xb[-1, :np_last] @ Gp
        return y, z_out

    def apply(self, x: torch.Tensor, z: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Exact lfilter of the 1-D `x` through the cascade from state `z`;
        returns (y, z'). The coefficients are real, so a complex `x` is its
        real and imaginary parts filtered as two real signals, from the real
        and imaginary parts of `z` (a real `z` is a zero imaginary state);
        z' is then complex."""
        if x.is_complex():
            zc = z if z.is_complex() else torch.complex(z, torch.zeros_like(z))
            y_re, z_re = self.apply(x.real.contiguous(), zc.real.contiguous())
            y_im, z_im = self.apply(x.imag.contiguous(), zc.imag.contiguous())
            return torch.complex(y_re, y_im), torch.complex(z_re, z_im)
        n = x.shape[0]
        L = min(self.block, max(16, n))
        np_last = n - (-(-n // L) - 1) * L
        consts = self._constants(L, np_last, x.dtype, x.device)
        zs = z.reshape(self.n_sections, 2)
        z_out = []
        y = x
        for i in range(self.n_sections):
            y, zo = self._apply_section(y, zs[i], consts[i], np_last)
            z_out.append(zo)
        return y, torch.stack(z_out).reshape(-1)

    def zero_phase(self, x: torch.Tensor) -> torch.Tensor:
        """scipy filtfilt(b, a, x), default 'pad' method."""
        b, a = self.ba()
        padlen = 3 * max(len(b), len(a))
        n = x.shape[0]
        if n <= padlen:
            raise ValueError(f"input too short for filtfilt: {n} <= {padlen}")
        head = 2 * x[0] - x[1:padlen + 1].flip(0)
        tail = 2 * x[-1] - x[-padlen - 1:-1].flip(0)
        ext = torch.cat([head, x, tail])
        zi = self._step_state(x.dtype, x.device)
        yf, _ = self.apply(ext, zi * ext[0])
        yr = yf.flip(0)
        yb, _ = self.apply(yr, zi * yr[0])
        return yb.flip(0)[padlen:padlen + n]
