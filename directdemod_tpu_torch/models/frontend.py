"""Fused digital down-converter (DDC) + FM front end.

Port of `directdemod_tpu/models/frontend.py:41-380`. The reference chain
`NCO -> FIR -> integer-stride decimation -> FM discriminator` collapses into
one strided convolution with NCO-modulated taps (host fp64),

    y[J m] = e^{-j w J m} c[m],   c[m] = sum_k (b[k] e^{j w k}) x[J m - k],

and the discriminator cancels the residual phasor up to one constant
rotation, angle(c[m] conj(c[m-1]) e^{-j w J}).

Block 0 of a stream runs `ops.fir.fir_decimate` (a complex `F.conv1d`): its
history is the virtual all-ones NCO stream (`hist0`), which no byte string
can express. Every later raw-byte block runs K1 (`ops.ddc.ddc_fm_u8`), the
CUDA kernel on a card and its plain version on the CPU. Complex blocks (a
source without raw bytes) run `fir_decimate` throughout.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..io.feeder import BlockFeeder
from ..ops import ddc, fir, resample as rs, unpack


class DdcFm:
    """Fused shift + filter + decimate + FM front end. `freq` is the channel
    offset in Hz, `taps` the FIR window, `bw_target` the rate the integer
    stride aims at (the reference's first bwLim)."""

    def __init__(self, fs: int, freq: float, taps, bw_target: int):
        stride, out_rate = rs.decim_params(fs, bw_target)
        k = len(taps)
        w = 2.0 * np.pi * float(freq) / float(fs)
        self._set(np.asarray(taps, dtype=np.float64) * np.exp(1j * w * np.arange(k)),
                  np.exp(-1j * w * stride),
                  np.exp(1j * w * np.arange(-(k - 1), 0)), stride)
        self.out_rate = out_rate

    @classmethod
    def from_numpy(cls, taps_mod, rot, hist0, stride: int) -> "DdcFm":
        """A front end from its host constants (e.g. those of the JAX
        package's DdcFm): modulated taps, discriminator rotation, block-0
        history and stride. `out_rate` stays unknown (None)."""
        fe = cls.__new__(cls)
        fe._set(taps_mod, rot, hist0, stride)
        fe.out_rate = None
        return fe

    def _set(self, taps_mod, rot, hist0, stride: int) -> None:
        self.taps_mod = np.asarray(taps_mod, dtype=np.complex128)
        self.rot = complex(rot)
        self.hist0 = np.asarray(hist0, dtype=np.complex128)
        self.stride = int(stride)
        self._dev_consts: dict = {}

    @property
    def ntaps(self) -> int:
        return len(self.taps_mod)

    def consts(self, device) -> tuple[torch.Tensor, ...]:
        """(taps_mod, taps_rev, rot (1,), hist0) as complex64 on `device`."""
        device = torch.device(device)
        c = self._dev_consts.get(device)
        if c is None:
            def t(a):
                return torch.as_tensor(np.asarray(a), dtype=torch.complex64,
                                       device=device).contiguous()
            c = self._dev_consts[device] = (
                t(self.taps_mod), t(self.taps_mod[::-1].copy()),
                t([self.rot]), t(self.hist0))
        return c

    def resident_frontend(self, raw: torch.Tensor, n: int) -> torch.Tensor:
        """Whole-capture front end over `n` samples of raw bytes that already
        sit on the device: block 0 (PROC_CHUNKSIZE samples) through
        `fir_decimate`, the whole remainder through ONE K1 call (its byte
        offsets are 64-bit, so no chunking is needed). The per-output windows
        are those of the blocked `DdcFmStream`."""
        j, k = self.stride, self.ntaps
        taps_mod, taps_rev, rot, hist0 = self.consts(raw.device)
        b0 = min(n, constants.PROC_CHUNKSIZE)
        x0 = unpack.iq_u8_to_complex(raw[: 2 * b0])
        c, _ = fir.fir_decimate(x0, taps_mod, hist0, 0,
                                rs.decim_count(b0, 0, j), j)
        audio0 = torch.angle(c[1:] * c[:-1].conj() * rot)
        if b0 >= n:
            return audio0
        off = rs.decim_phase(b0, j)
        out_len = rs.decim_count(n - b0, off, j)
        seg = raw[2 * (b0 - (k - 1) + off): 2 * n]
        audio1, _ = ddc.ddc_fm_u8(seg, taps_rev, rot, c[-1:].contiguous(), j,
                                  out_len)
        return torch.cat([audio0, audio1])

    def process(self, source, block_size: int = constants.PROC_CHUNKSIZE,
                device="cpu") -> tuple[np.ndarray, int]:
        """Blocked run over a whole source on `device`; returns (host audio,
        out_rate)."""
        stream = DdcFmStream(self, device)
        outs = [stream.step(x, s).cpu()
                for s, _, x in BlockFeeder(source, block_size, device)]
        return torch.cat(outs).numpy(), self.out_rate


class DdcFmStream:
    """Block-by-block front end with the stream carry: the complex conv
    history `hist` (K-1 samples), the last conv output `c_prev`, and for a
    raw-byte stream the last 2(K-1) bytes `raw_hist`, from which `hist` is
    rebuilt when a complex block follows raw ones."""

    def __init__(self, fe: DdcFm, device="cpu"):
        self.fe = fe
        self.device = torch.device(device)
        _, _, _, hist0 = fe.consts(self.device)
        self.hist = hist0
        self.c_prev = torch.zeros(1, dtype=torch.complex64, device=self.device)
        self.raw_hist = None

    def load_state(self, hist, c_prev, raw_hist=None) -> None:
        """Take over a stream's carry given as host arrays (e.g. the JAX
        DdcFmStream's `state` and `raw_hist`); `hist` may be None when
        `raw_hist` is given."""
        def t(a, dtype):
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=self.device).contiguous()
        self.hist = None if hist is None else t(hist, torch.complex64)
        self.c_prev = t(c_prev, torch.complex64).reshape(1)
        self.raw_hist = None if raw_hist is None else t(raw_hist, torch.uint8)

    def step(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """One block (complex64, or raw uint8 bytes) at global sample index
        `s`, on the stream's device; returns the block's audio."""
        fe = self.fe
        j, k = fe.stride, fe.ntaps
        taps_mod, taps_rev, rot, _ = fe.consts(self.device)
        is_u8 = x.dtype == torch.uint8
        n = x.shape[0] // 2 if is_u8 else x.shape[0]
        off = rs.decim_phase(s, j)
        out_len = rs.decim_count(n, off, j)
        if is_u8 and s > 0 and self.raw_hist is not None and out_len > 0:
            raw_cat = torch.cat([self.raw_hist, x])
            audio, self.c_prev = ddc.ddc_fm_u8(raw_cat[2 * off:], taps_rev,
                                               rot, self.c_prev, j, out_len)
            self.hist = None
            self.raw_hist = raw_cat[-2 * (k - 1):].clone()
            return audio
        if self.hist is None:
            self.hist = unpack.iq_u8_to_complex(self.raw_hist)
        xc = unpack.iq_u8_to_complex(x) if is_u8 else x.to(torch.complex64)
        if out_len == 0:
            # a block shorter than its decimator phase has no output; only
            # the histories move on
            self.hist = torch.cat([self.hist, xc])[-(k - 1):]
            self.raw_hist = (torch.cat([self.raw_hist, x])[-2 * (k - 1):]
                             if is_u8 and self.raw_hist is not None else None)
            return torch.empty(0, dtype=torch.float32, device=self.device)
        c, self.hist = fir.fir_decimate(xc, taps_mod, self.hist, off, out_len, j)
        if s == 0:
            audio = torch.angle(c[1:] * c[:-1].conj() * rot)
        else:
            prev = torch.cat([self.c_prev, c[:-1]])
            audio = torch.angle(c * prev.conj() * rot)
        self.c_prev = c[-1:].contiguous()
        self.raw_hist = x[-2 * (k - 1):] if is_u8 else None
        return audio
