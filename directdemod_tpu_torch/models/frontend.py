"""Fused digital down-converter (DDC) + FM front end.

Port of `directdemod_tpu/models/frontend.py:41-380`. The reference chain
`NCO -> FIR -> integer-stride decimation -> FM discriminator` collapses into
one strided convolution with NCO-modulated taps (host fp64),

    y[J m] = e^{-j w J m} c[m],   c[m] = sum_k (b[k] e^{j w k}) x[J m - k],

and the discriminator cancels the residual phasor up to one constant
rotation, angle(c[m] conj(c[m-1]) e^{-j w J}).

`DdcFmStream` runs a front end block by block. With the FM discriminator
and complex64 samples (the default) every block goes through a kernel of
`ops.ddc`: raw uint8 bytes through K1 (`ddc_fm_u8`) over [last K-1 samples'
bytes | block], complex samples through K4 (`ddc_fm_c64`) over [last K-1
samples | block], the CUDA kernels on a card and their plain versions on the
CPU. The kernels read the history and the block through two pointers, so no
block is copied. Block 0's history is the virtual all-ones NCO stream
(`hist0`, one per channel). For one channel on complex samples it is a
sample history like any other, and K4 runs over [hist0 | block]. No byte
string, and no history shared by several channels, can express it: there
the few outputs whose windows reach into it are one small `F.conv1d` a
channel, and the rest of the block goes through the kernel. A stream without the
discriminator (`fm=False`, the complex decimated stream) or in complex128
runs `ops.fir.fir_decimate`, as the JAX package runs all of them through
XLA: the kernels are float32 only. The same stream runs a bank of channels
(`models.multichannel.MultiDdcFm`): one kernel launch a block for all of
them.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants
from ..device import resolve
from ..io.feeder import BlockFeeder
from ..ops import ddc, fir, resample as rs, unpack

_COMPLEX = (torch.complex64, torch.complex128)


class DdcFm:
    """Fused shift + filter + decimate (+ FM) front end. `freq` is the
    channel offset in Hz, `taps` the FIR window, `bw_target` the rate the
    integer stride aims at (the reference's first bwLim), `fm` whether the
    discriminator is fused in (else the complex decimated stream comes
    out)."""

    channels = None          # one channel: 1-D outputs

    def __init__(self, fs: int, freq: float, taps, bw_target: int,
                 fm: bool = True):
        stride, out_rate = rs.decim_params(fs, bw_target)
        k = len(taps)
        w = 2.0 * np.pi * float(freq) / float(fs)
        self._set(np.asarray(taps, dtype=np.float64) * np.exp(1j * w * np.arange(k)),
                  np.exp(-1j * w * stride),
                  np.exp(1j * w * np.arange(-(k - 1), 0)), stride, fm)
        self.out_rate = out_rate

    @classmethod
    def from_numpy(cls, taps_mod, rot, hist0, stride: int, fm: bool = True
                   ) -> "DdcFm":
        """A front end from its host constants (e.g. those of the JAX
        package's DdcFm): modulated taps, discriminator rotation, block-0
        history and stride. `out_rate` stays unknown (None)."""
        fe = cls.__new__(cls)
        fe._set(taps_mod, rot, hist0, stride, fm)
        fe.out_rate = None
        return fe

    def _set(self, taps_mod, rot, hist0, stride: int, fm: bool) -> None:
        self.taps_mod = np.asarray(taps_mod, dtype=np.complex128)
        self.rot = np.asarray(rot, dtype=np.complex128)
        self.hist0 = np.asarray(hist0, dtype=np.complex128)
        self.stride = int(stride)
        self.fm = bool(fm)
        self._dev_consts: dict = {}

    @property
    def ntaps(self) -> int:
        return self.taps_mod.shape[-1]

    def consts(self, device, dtype=torch.complex64) -> tuple[torch.Tensor, ...]:
        """(taps_mod, taps_rev, rot, hist0) in `dtype` on `device`: (K,),
        (K,), (1,), (K-1,) for one channel; (C, K), (C, K), (C,), (C, K-1)
        for a bank."""
        key = (torch.device(device), dtype)
        c = self._dev_consts.get(key)
        if c is None:
            def t(a):
                return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                       device=key[0])
            c = self._dev_consts[key] = (
                t(self.taps_mod), t(self.taps_mod[..., ::-1]),
                t(self.rot.reshape(-1)), t(self.hist0))
        return c

    def resident_frontend(self, raw: torch.Tensor, n: int) -> torch.Tensor:
        """Whole-capture front end over `n` samples of raw bytes that already
        sit on the device: the capture as one block of `DdcFmStream`, so one
        K1 call over all of it (its sample offsets are 64-bit). The outputs
        are those of the blocked stream, bit for bit."""
        return DdcFmStream(self, raw.device).step(raw[: 2 * n], 0)

    # ------------------------------------------------ the functional block API
    def init_state(self, dtype=torch.complex64, device=None) -> tuple:
        """The state before block 0 of the reference's functional block
        API (`init_state` / `process_block`): (history, c_prev), the
        virtual all-ones NCO history, (K-1,), and c_prev, (1,), in `dtype`
        on `device` (the port's device rule)."""
        dev = resolve(device)
        _, _, rot, hist0 = self.consts(dev, dtype)
        return hist0.clone(), torch.zeros(rot.shape[0], dtype=dtype, device=dev)

    def block_out_len(self, start: int, n: int) -> int:
        """Outputs of an n-sample block at global sample `start`."""
        return rs.decim_count(n, rs.decim_phase(start, self.stride), self.stride)

    def process_block(self, x: torch.Tensor, state: tuple, start: int
                      ) -> tuple[torch.Tensor, tuple]:
        """One block (complex, or raw uint8 bytes) at global sample
        `start` from `state` -> (its output, the next state): a
        `DdcFmStream.step` from the state's carry, on the state's device in
        its dtype, so a float32 block on a card runs K1 or K4 as the stream
        does. The state passed in is not changed."""
        hist, c_prev = state
        stream = DdcFmStream(self, c_prev.device, c_prev.dtype)
        stream.hist, stream.c_prev = hist, c_prev.reshape(-1)
        y = stream.step(x, start)
        return y, (stream.hist, stream.c_prev.reshape(c_prev.shape))

    def process(self, source, block_size: int = constants.PROC_CHUNKSIZE,
                device=None, dtype=torch.complex64) -> tuple[np.ndarray, int]:
        """Blocked run over a whole source on `device` (the port's device
        rule, `device.resolve`) in `dtype`; returns (host output, out_rate).
        A source with raw bytes feeds them as they are."""
        stream = DdcFmStream(self, device, dtype)
        outs = [stream.step(x, s).cpu()
                for s, _, x in BlockFeeder(source, block_size, stream.device, dtype)]
        return torch.cat(outs, dim=-1).numpy(), self.out_rate


class DdcFmStream:
    """Block-by-block front end with the stream carry: the last conv output
    `c_prev` and the history `hist`, the last K-1 samples in the form of the
    last block: its 2(K-1) bytes after a raw block, complex samples after a
    complex one. Before the first block it is the virtual all-ones NCO
    history `hist0`, (K-1,) for one channel and (C, K-1) for a bank, whose
    history stays per channel until K-1 samples have gone by. A stream may
    take raw blocks and then complex ones, or the reverse, as the JAX
    package's stream does, whose carry `load_state` takes over."""

    def __init__(self, fe: DdcFm, device=None, dtype=torch.complex64):
        if dtype not in _COMPLEX:
            raise ValueError(f"stream dtype {dtype}: complex64 or complex128")
        self.fe = fe
        self.device = resolve(device)
        self.dtype = dtype
        _, _, rot, self.hist = fe.consts(self.device, dtype)
        self.c_prev = torch.zeros(rot.shape[0], dtype=dtype, device=self.device)

    def load_state(self, hist, c_prev, raw_hist=None) -> None:
        """Take over a stream's carry given as host arrays (e.g. the JAX
        DdcFmStream's `state` and `raw_hist`): the history is `raw_hist`
        (bytes) when it is given, else `hist` (complex samples)."""
        def t(a, dtype):
            return torch.as_tensor(np.array(a), dtype=dtype,
                                   device=self.device).contiguous()
        self.hist = (t(hist, self.dtype) if raw_hist is None
                     else t(raw_hist, torch.uint8))
        self.c_prev = t(c_prev, self.dtype).reshape(-1)

    def _samples(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            return unpack.iq_u8_to_complex(x, self.dtype)
        return x.to(self.dtype)

    def step(self, x: torch.Tensor, s: int) -> torch.Tensor:
        """One block (complex, or raw uint8 bytes) at global sample index
        `s`, on the stream's device; returns the block's output, (L,) for
        one channel and (C, L) for a bank. Block 0 (s == 0) drops its first
        FM output, as the reference's first chunk does."""
        fe = self.fe
        j = fe.stride
        is_u8 = x.dtype == torch.uint8
        n = x.shape[0] // 2 if is_u8 else x.shape[0]
        off = rs.decim_phase(s, j)
        out_len = rs.decim_count(n, off, j)
        if out_len == 0:
            # a block shorter than its decimator phase has no output; only
            # the history moves on
            real = torch.float64 if self.dtype == torch.complex128 else torch.float32
            out = torch.empty(self.c_prev.shape[0], 0, device=self.device,
                              dtype=real if fe.fm else self.dtype)
        elif fe.fm and self.dtype == torch.complex64:
            out = self._kernel_block(x, is_u8, off, out_len, s == 0)
        else:
            out = self._fir_block(x, off, out_len, s == 0)
        self._advance(x, is_u8, n)
        return out[0] if fe.channels is None else out

    def _advance(self, x: torch.Tensor, is_u8: bool, n: int) -> None:
        """The history after the block `x` of n samples: the last K-1
        samples of [hist | x], in x's form once x alone holds them."""
        k = self.fe.ntaps
        h = self.hist
        if n >= k - 1:
            self.hist = (x[-2 * (k - 1):] if is_u8
                         else self._samples(x[-(k - 1):])).clone()
        elif is_u8 and h.dtype == torch.uint8:
            self.hist = torch.cat([h, x])[-2 * (k - 1):]
        else:
            h = self._samples(h)
            self.hist = torch.cat([h, self._samples(x).expand(h.shape[:-1] + (-1,))],
                                  dim=-1)[..., -(k - 1):].clone()

    def _kernel_block(self, x, is_u8, off, out_len, first):
        """K1 (raw block) or K4 (complex block) over [hist | x][off:]. The
        kernel reads the history in place when it is one history in the
        block's own form; otherwise (per channel, or raw beside complex) the
        outputs whose windows reach into it come from `ddc.conv_windows`
        first and the kernel takes the rest of the block."""
        fe = self.fe
        j, k = fe.stride, fe.ntaps
        _, taps_rev, rot, _ = fe.consts(self.device)
        taps_rev = taps_rev.reshape(rot.shape[0], -1)      # (C, K)
        kern = ddc.ddc_fm_u8 if is_u8 else ddc.ddc_fm_c64
        per = 2 if is_u8 else 1                            # elements a sample
        xs = x if is_u8 else self._samples(x)
        h = self.hist
        if h.dim() == 1 and (h.dtype == torch.uint8) == is_u8:
            nh = h.shape[0] // per
            head, src = (h[per * off:], xs) if off < nh else (None, xs[per * (off - nh):])
            audio, self.c_prev = kern(src, taps_rev, rot, self.c_prev, j, out_len,
                                      head=head)
        else:
            # head: outputs m with off + m*J < K-1 read the history
            nh = min(out_len, max(0, -(-(k - 1 - off) // j)))
            c_prev, audio = self.c_prev, []
            if nh:
                hs = self._samples(h).reshape(-1, k - 1).expand(rot.shape[0], -1)
                xh = self._samples(x[: per * (off + nh * j)])
                seg = torch.cat([hs, xh.expand(rot.shape[0], -1)], dim=1)[:, off:]
                c_head = torch.cat([ddc.conv_windows(seg[ch], taps_rev[ch], j, nh)
                                    for ch in range(rot.shape[0])])
                prev = torch.cat([c_prev[:, None], c_head[:, :-1]], dim=1)
                audio.append(torch.angle(c_head * prev.conj() * rot[:, None]))
                c_prev = c_head[:, -1].contiguous()
            if out_len > nh:
                start = off + nh * j - (k - 1)          # first body window in x
                body, c_prev = kern(xs[per * start:], taps_rev, rot, c_prev, j,
                                    out_len - nh)
                audio.append(body)
            audio = torch.cat(audio, dim=1)
            self.c_prev = c_prev
        return audio[:, 1:] if first else audio

    def _fir_block(self, x, off, out_len, first):
        """`fir.fir_decimate` a channel, then the discriminator (in the
        stream's precision) if the front end has one."""
        fe = self.fe
        taps_mod, _, rot, _ = fe.consts(self.device, self.dtype)
        taps_mod = taps_mod.reshape(rot.shape[0], -1)
        hs = self._samples(self.hist)
        xc = self._samples(x)
        c = torch.stack([
            fir.fir_decimate(xc, taps_mod[ch], hs[ch] if hs.dim() == 2 else hs,
                             off, out_len, fe.stride)[0]
            for ch in range(rot.shape[0])])
        prev = torch.cat([self.c_prev[:, None], c[:, :-1]], dim=1)
        self.c_prev = c[:, -1].contiguous()
        if not fe.fm:
            return c
        audio = torch.angle(c * prev.conj() * rot[:, None])
        return audio[:, 1:] if first else audio
