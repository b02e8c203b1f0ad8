"""The fused DDC (+FM) front end over the `time` axis of a mesh.

Port of `directdemod_tpu/parallel/sharded.py:36-188`. The sequential block
loop (ref decode_noaa.py:617-624) becomes waves of blocks, one block a
`time` shard. The only coupling between blocks in the front end is

  * FIR history      -> the last K-1 input samples of the block before
  * FM boundary c    -> one more window, reaching J samples back
  * decimator phase  -> closed form in the block's first sample (no comms)
  * NCO phase        -> folded into the taps (no comms)

so each shard takes the last K-1+J samples of the block before it as a
halo (`mesh.ppermute`; the first shard of a wave takes them from the last
block of the wave before) and runs the stream's kernel over [halo | block]
with ONE extra output in front: that output is the c of the last output
before the block, computed by the same kernel, so its discriminator needs
no carried state. K1 (`ops.ddc.ddc_fm_u8`) takes raw bytes and K4
(`ddc_fm_c64`) complex64 samples, the halo as `head=`; complex128 and
`fm=False` run `ops.fir.fir_decimate`, as `DdcFmStream` does. The
capture's first block is the stream's own first step (its virtual all-ones
NCO history), and the blocks after the last whole wave (the remainder and
the ragged end) run sequentially in a `DdcFmStream` that takes over the
last wave's history and c. Every output is the sequential stream's: on a
card the kernels compute each output by the same sequence of operations
whatever block it falls in, so the two agree bit for bit. The blocks come
from the stream's own feed (`io.feeder.BlockFeeder`: a source with bytes on
a device is sliced there) and go to their shard's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.feeder import BlockFeeder
from ..models.frontend import DdcFm, DdcFmStream
from ..ops import ddc, fir, resample as rs, unpack
from ..stream.plan import plan_blocks
from .mesh import Mesh, ppermute


class ShardedDdcFm:
    """A one-channel `DdcFm` run in waves of blocks over `mesh`'s `time`
    shards; `process` returns what `DdcFm.process` returns."""

    def __init__(self, fe: DdcFm, mesh: Mesh):
        if fe.channels is not None:
            raise ValueError("ShardedDdcFm runs a one-channel DdcFm")
        self.fe = fe
        self.mesh = mesh
        self.halo = fe.ntaps - 1 + fe.stride

    def _chunk(self, x: torch.Tensor, halo: torch.Tensor, s: int, dtype
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """One block x at global sample s > 0 with its halo (the same form:
        bytes or samples) -> (its outputs, the c of its last output)."""
        fe = self.fe
        j, k = fe.stride, fe.ntaps
        is_u8 = x.dtype == torch.uint8
        n = x.shape[0] // 2 if is_u8 else x.shape[0]
        off = rs.decim_phase(s, j)
        cnt = rs.decim_count(n, off, j)
        if fe.fm and dtype == torch.complex64:
            _, taps_rev, rot, _ = fe.consts(x.device)
            kern = ddc.ddc_fm_u8 if is_u8 else ddc.ddc_fm_c64
            per = 2 if is_u8 else 1
            audio, c_last = kern(x, taps_rev, rot, torch.zeros_like(rot), j, cnt + 1,
                                 head=halo[per * off:])
            return audio[1:], c_last

        def samples(t):
            return unpack.iq_u8_to_complex(t, dtype) if is_u8 else t.to(dtype)
        taps_mod, _, rot, _ = fe.consts(x.device, dtype)
        hs = samples(halo)
        # the block seen from J samples earlier (the same decimator phase):
        # one more window, the c before the block's first output
        c, _ = fir.fir_decimate(torch.cat([hs[k - 1:], samples(x)]), taps_mod,
                                hs[: k - 1], off, cnt + 1, j)
        if not fe.fm:
            return c[1:], c[-1:]
        return torch.angle(c[1:] * c[:-1].conj() * rot), c[-1:]

    def process(self, source, block_size: int, dtype=torch.complex64
                ) -> tuple[np.ndarray, int]:
        """Wave-parallel run over the whole source; the outputs (on the
        host) and the output rate of `DdcFm.process` on the same blocks."""
        if block_size < self.halo:
            raise ValueError(f"block_size {block_size} is shorter than the "
                             f"halo of {self.halo} samples")
        fe = self.fe
        k = fe.ntaps
        devs = self.mesh.time_devices
        ndev = len(devs)
        plan = plan_blocks(source.length, block_size)
        # the whole blocks lead the plan; the waves take all they can
        n_waves = sum(e - s == block_size for s, e in plan) // ndev
        feed = iter(BlockFeeder(source, device=devs[0], dtype=dtype, blocks=plan))
        outs: list = []
        tail = c_last = None
        for w in range(n_waves):
            wave = [next(feed) for _ in devs]
            chunks = [x.to(d) for (_, _, x), d in zip(wave, devs)]
            per = 2 if chunks[0].dtype == torch.uint8 else 1
            tails = [x[-per * self.halo:] for x in chunks]
            halos = ppermute(tails, [(i, i + 1) for i in range(ndev - 1)], devs)
            if w:
                halos[0] = tail.to(devs[0], copy=True)
            for (s, _, _), x, h in zip(wave, chunks, halos):
                if s == 0:
                    first = DdcFmStream(fe, x.device, dtype)
                    y = first.step(x, 0)
                    c_last = first.c_prev
                else:
                    y, c_last = self._chunk(x, h, s, dtype)
                outs.append(y.cpu())
            tail = tails[-1]

        # the blocks after the last whole wave, sequentially
        stream = DdcFmStream(fe, devs[0], dtype)
        if n_waves:
            stream.hist = tail[-per * (k - 1):].to(devs[0], copy=True)
            stream.c_prev = c_last.to(devs[0])
        outs += [stream.step(x, s).cpu() for s, _, x in feed]
        return torch.cat(outs).numpy(), fe.out_rate
