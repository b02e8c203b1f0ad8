"""FIR filtering as strided convolution.

Port of `directdemod_tpu/ops/fir.py:117-221`: the stateful chunked FIR
(overlap-save: the carried state is the last `ntaps-1` input samples, all
ones before the first block), the fused filter + stride-decimation that
computes only the kept outputs, scipy's `filtfilt(b, [1], x)` zero-phase
mode, and NumPy's / SciPy's 'same'-mode convolution and correlation. All of them are `F.conv1d` calls
over the last axis; leading axes are batch axes.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _rconv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Real VALID cross-correlation sum_i w[i] x[..., stride*m + i]."""
    lead = x.shape[:-1]
    y = F.conv1d(x.reshape(-1, 1, x.shape[-1]), w.reshape(1, 1, -1),
                 stride=stride)
    return y.reshape(lead + (y.shape[-1],))


def conv_valid(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """VALID sliding dot product sum_i w[i] x[..., stride*m + i], complex-aware
    (taps are not flipped)."""
    if not w.is_complex():
        rdt = x.real.dtype if x.is_complex() else x.dtype
        w = w.to(rdt)
        if not x.is_complex():
            return _rconv(x, w, stride)
        # real taps on complex data: re and im ride as two batch rows
        y = _rconv(torch.view_as_real(x).movedim(-1, -2), w, stride)
        return torch.complex(y[..., 0, :], y[..., 1, :])
    if not x.is_complex():
        x = x.to(w.dtype)
    w = w.to(x.dtype)
    lead, n = x.shape[:-1], x.shape[-1]
    # complex taps: one 2-in / 2-out channel convolution,
    # re = xr*wr - xi*wi, im = xr*wi + xi*wr
    wr, wi = w.real, w.imag
    weight = torch.stack([torch.stack([wr, -wi]), torch.stack([wi, wr])])
    xs = torch.view_as_real(x).movedim(-1, -2).reshape(-1, 2, n)
    y = F.conv1d(xs, weight, stride=stride)
    return torch.complex(y[:, 0], y[:, 1]).reshape(lead + (y.shape[-1],))


def fir_apply(x: torch.Tensor, taps: torch.Tensor, hist: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stateful FIR y[n] = sum_k b[k] x[n-k] over the last axis, with `hist`
    the k-1 inputs before x; scipy `lfilter(b, [1], x, zi)` with the state
    carried. Returns (y, new_hist) with y as long as x."""
    k = taps.shape[0]
    xp = torch.cat([hist.to(x.dtype), x], dim=-1)
    return conv_valid(xp, taps.flip(0)), xp[..., -(k - 1):]


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, hist: torch.Tensor,
                 off: int, out_len: int, stride: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FIR + decimation producing y[off + stride*m], m < out_len:
    filtering the whole block then taking `[off::stride]`, without
    computing the dropped outputs. The last kept output lies inside the
    block, so its window ends inside [hist | x]."""
    k = taps.shape[0]
    xp = torch.cat([hist.to(x.dtype), x])
    seg = xp[off:off + (out_len - 1) * stride + k]
    return conv_valid(seg, taps.flip(0), stride), xp[-(k - 1):]


def fir_zero_phase(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Zero-phase FIR along the last axis == scipy `filtfilt(b, [1], x)`.

    filtfilt's default 'pad' method: odd extension of 3*ntaps samples at
    both ends, forward pass seeded with a constant x[0] history (a FIR's
    `zi * x[0]`), backward pass likewise, then crop."""
    k = int(np.asarray(taps).shape[0])
    padlen = 3 * k
    n = x.shape[-1]
    if n <= padlen:
        raise ValueError(f"input too short for filtfilt: {n} <= {padlen}")
    rdt = x.real.dtype if x.is_complex() else x.dtype
    t = torch.as_tensor(np.asarray(taps), dtype=rdt, device=x.device)
    head = 2 * x[..., :1] - x[..., 1:padlen + 1].flip(-1)
    tail = 2 * x[..., -1:] - x[..., -padlen - 1:-1].flip(-1)
    ext = torch.cat([head, x, tail], dim=-1)
    yf, _ = fir_apply(ext, t, ext[..., :1].expand(ext.shape[:-1] + (k - 1,)))
    yr = yf.flip(-1)
    yb, _ = fir_apply(yr, t, yr[..., :1].expand(yr.shape[:-1] + (k - 1,)))
    return yb.flip(-1)[..., padlen:padlen + n]


def ones_history(ntaps: int, dtype, device=None) -> torch.Tensor:
    """First-block FIR history reproducing the reference's lfilter_zi seed:
    an all-ones past input (`design.step_history_equivalent` in the JAX
    package)."""
    return torch.ones(ntaps - 1, dtype=dtype, device=device)


def convolve_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """np.convolve(x, w, mode='same') over the last axis, as a direct
    convolution: 'same' keeps full-convolution samples
    [(k-1)//2, (k-1)//2 + n)."""
    k = w.shape[0]
    lpad = (k - 1) // 2
    xp = F.pad(x, (k - 1 - lpad, lpad))
    return conv_valid(xp, w.flip(0))


def correlate_same(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """scipy.signal.correlate(x, w, 'same') for real taps, as a direct
    (never FFT) convolution. The AFSK edge detector feeds a peak walk with
    no threshold: its flat stretches must come out exactly zero, and FFT
    round-off there would create phantom peaks. Sums of small integers stay
    exact in fp32 (TF32 is off, see the package docstring)."""
    return convolve_same(x, w.flip(0))
