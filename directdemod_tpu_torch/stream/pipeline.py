"""The stream pipeline: a declarative chain of ops over a chunked source.

Port of `directdemod_tpu/stream/pipeline.py` (behavioral reference: the
reference's mutating `commSignal` op chain and chunker KV store, ref
comm.py:15-181, chunker.py:54-84). Every cross-block state of an op lives
in an explicit list, one entry an op (FIR history, IIR section states, FM
boundary sample, or None); everything else (NCO phase, decimator phase,
output lengths) is closed-form per-block metadata computed on the host
from global sample indices. The JAX package compiles one jitted step for
each metadata key; here a block runs through the ops eagerly, one after
the other, so there is no step cache.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from ..constants import PROC_CHUNKSIZE
from ..device import resolve
from ..io.feeder import BlockFeeder
from ..ops import fir, fm as fm_ops, iir as iir_ops, nco, resample as rs
from . import checkpoint as ckpt
from .plan import plan_blocks


def _real(dtype):
    return torch.float64 if dtype in (torch.float64, torch.complex128) \
        else torch.float32


class StreamOp:
    """One stage of the chain: host-side bookkeeping plus `apply`, the
    work on a block's tensor."""

    def out_rate(self, fs: int) -> int:
        """Sampling-rate transform (host, at build time)."""
        return fs

    def out_span(self, start: int, n: int) -> tuple[int, int]:
        """(out_start, out_len) given this op's input global start and
        length (host)."""
        return start, n

    def init_state(self, dtype, device):
        return None

    def host_meta(self, start: int, n: int) -> tuple[Any, Any]:
        """(meta, aux) of the block starting at global `start`."""
        return None, None

    def apply(self, x, state, aux, meta):
        raise NotImplementedError


@dataclass
class Shift(StreamOp):
    """NCO frequency offset (ref comm.py:63-78). The phase is a function of
    the global sample index, anchored in float64 on the host."""
    freq: float
    fs: int = 0            # filled by Pipeline
    anchor_dtype: Any = np.float32

    def host_meta(self, start, n):
        return None, nco.phase_anchors(self.freq, self.fs, start, n,
                                       dtype=self.anchor_dtype)

    def apply(self, x, state, aux, meta):
        if self.freq == 0:
            return x, state
        omega = float(self.anchor_dtype(-2.0 * np.pi * self.freq / self.fs))
        return nco.mix(x, omega, torch.as_tensor(aux, device=x.device)), state


@dataclass
class Filter(StreamOp):
    """Stateful FIR (ref filters.py:53-70 via comm.py:80-92), the history
    all ones before the first block."""
    taps: np.ndarray

    def init_state(self, dtype, device):
        return fir.ones_history(len(self.taps), dtype, device)

    def apply(self, x, state, aux, meta):
        t = torch.as_tensor(np.asarray(self.taps), dtype=_real(x.dtype),
                            device=x.device)
        return fir.fir_apply(x, t, state)


@dataclass
class FilterZeroPhase(StreamOp):
    """Zero-phase FIR (filtfilt, ref filters.py:73); stateless, on whole
    blocks."""
    taps: np.ndarray

    def apply(self, x, state, aux, meta):
        return fir.fir_zero_phase(x, np.asarray(self.taps)), state


@dataclass
class Butter(StreamOp):
    """Stateful Butterworth through block-parallel second-order sections
    (ref filters.py:232-273), seeded with the unit-step steady state."""
    filt: iir_ops.IirFilter

    def init_state(self, dtype, device):
        return self.filt.initial_state_step(_real(dtype), device).to(dtype)

    def apply(self, x, state, aux, meta):
        return self.filt.apply(x, state)


@dataclass
class ButterZeroPhase(StreamOp):
    filt: iir_ops.IirFilter

    def apply(self, x, state, aux, meta):
        return self.filt.zero_phase(x), state


@dataclass
class BwLim(StreamOp):
    """Integer-stride decimation with phase continuity (ref comm.py:118-129):
    the phase is closed-form in the global input index, so the op has no
    state. The rate keeps the reference's int truncation."""
    target: int
    fs: int = 0
    stride: int = 0

    def out_rate(self, fs):
        self.fs = fs
        self.stride, new_rate = rs.decim_params(fs, self.target)
        return new_rate

    def out_span(self, start, n):
        off = rs.decim_phase(start, self.stride)
        return -(-start // self.stride), rs.decim_count(n, off, self.stride)

    def host_meta(self, start, n):
        off = rs.decim_phase(start, self.stride)
        return rs.decim_count(n, off, self.stride), off

    def apply(self, x, state, aux, meta):
        return rs.decimate(x, aux, self.stride, meta), state


@dataclass
class Resample(StreamOp):
    """Per-block exact-rate FFT resample (bwLim strict, ref comm.py:110-116);
    blocks must come in order."""
    target: int
    fs: int = 0
    _cum_in: int = 0
    _cum_out: int = 0

    def out_rate(self, fs):
        self.fs = fs
        return self.target

    def out_span(self, start, n):
        out_n = int(self.target * n / self.fs)
        if start != self._cum_in:
            raise RuntimeError("Resample blocks must be processed in order")
        out_start = self._cum_out
        self._cum_in += n
        self._cum_out += out_n
        return out_start, out_n

    def host_meta(self, start, n):
        return int(self.target * n / self.fs), None

    def apply(self, x, state, aux, meta):
        return rs.fft_resample(x, meta), state


@dataclass
class FmDemod(StreamOp):
    """Polar discriminator with the boundary sample carried (ref
    demod_fm.py:29-51); the first block's output is one sample shorter."""

    def out_span(self, start, n):
        return (start - 1, n) if start > 0 else (0, n - 1)

    def host_meta(self, start, n):
        return bool(start > 0), None

    def init_state(self, dtype, device):
        return torch.zeros(1, dtype=dtype, device=device)

    def apply(self, x, state, aux, meta):
        return fm_ops.quad_demod(x, state if meta else None)


@dataclass
class Apply(StreamOp):
    """funcApply (ref comm.py:132-144): any stateless function of a block's
    tensor."""
    fn: Callable

    def apply(self, x, state, aux, meta):
        return self.fn(x), state


class Pipeline:
    """A chain of StreamOps over a chunked source, on `device` (the port's
    device rule, `device.resolve`) in `dtype` (complex64 or complex128)."""

    def __init__(self, ops: Sequence[StreamOp], fs: int,
                 dtype=torch.complex64, device=None):
        self.ops = list(ops)
        self.in_rate = int(fs)
        self.dtype = dtype
        self.device = resolve(device)
        rate = int(fs)
        for op in self.ops:
            if isinstance(op, Shift):
                op.fs = rate
                op.anchor_dtype = (np.float64 if dtype == torch.complex128
                                   else np.float32)
            rate = op.out_rate(rate)
        self.out_rate = rate

    def reset(self) -> None:
        for op in self.ops:
            if isinstance(op, Resample):
                op._cum_in = 0
                op._cum_out = 0

    def init_states(self) -> list:
        states = []
        dt = self.dtype
        for op in self.ops:
            states.append(op.init_state(dt, self.device))
            # the state dtype follows the stream's at that point; FM is real
            if isinstance(op, FmDemod):
                dt = _real(dt)
        return states

    def block_metas(self, start: int, n: int):
        """Host metadata of one input block: per-op (meta, aux), and the
        output length."""
        metas, auxs = [], []
        s, ln = start, n
        for op in self.ops:
            m, a = op.host_meta(s, ln)
            metas.append(m)
            auxs.append(a)
            s, ln = op.out_span(s, ln)
        return metas, auxs, ln

    def step(self, x, states, auxs, metas):
        """One block through every op; returns (output, new states)."""
        new_states = []
        for op, st, aux, meta in zip(self.ops, states, auxs, metas):
            x, st = op.apply(x, st, aux, meta)
            new_states.append(st)
        return x, new_states

    def process(self, source, block_size: int = PROC_CHUNKSIZE,
                collect: bool = True, checkpoint_path: str | None = None,
                resume: bool = False):
        """Run the chunk loop over a source (anything with .length / .read,
        complex samples fed block by block). Returns (output ndarray | None,
        out_rate). With `checkpoint_path` the states and the position are
        saved after every block; `resume=True` restarts from the saved
        position (output already emitted is the caller's to keep)."""
        self.reset()
        states = self.init_states()
        resume_from = 0
        if resume and checkpoint_path is not None:
            states, resume_from, _ = ckpt.restore(checkpoint_path, states)
        plan = plan_blocks(source.length, block_size)
        for s, e in plan:
            if s < resume_from:
                # advance the host-side bookkeeping (strict resample counters)
                self.block_metas(s, e - s)
        todo = [(s, e) for s, e in plan if s >= resume_from]
        outs = []
        feed = BlockFeeder(source, block_size, self.device, self.dtype,
                           raw=False, blocks=todo)
        for s, e, x in feed:
            metas, auxs, _ = self.block_metas(s, e - s)
            y, states = self.step(x, states, auxs, metas)
            if checkpoint_path is not None:
                ckpt.save(checkpoint_path, states, e)
            if collect:
                outs.append(y.cpu())
        if collect:
            out = torch.cat(outs).numpy() if outs else np.empty(0)
            return out, self.out_rate
        return None, self.out_rate
