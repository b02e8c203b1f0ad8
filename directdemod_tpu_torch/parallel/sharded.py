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

On a mesh that spans processes (`parallel.distributed`) each process reads
only its own blocks of each wave; the halo of a process's first shard comes
from the previous process's last shard, the carry between waves from the
last process to the first, and the remainder runs on shard 0's owner. A
shard's arithmetic is the same in one process or several: only the
transport of its halo differs, so the outputs keep their bits. The outputs
are gathered (`mesh.gather_host`) so that every process returns all of
them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.feeder import BlockFeeder
from ..models.frontend import DdcFm, DdcFmStream
from ..ops import ddc, fir, resample as rs, unpack
from ..stream.plan import plan_blocks
from .mesh import Mesh, gather_host, ppermute


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

    def _wave(self, chunks: list, starts: list, carry_tail, dtype=torch.complex64
              ) -> tuple[list, torch.Tensor | None]:
        """One wave, a block a `time` shard: `chunks[i]` is shard i's block
        on its device (bytes or samples; None for another process's shard,
        as `distributed.global_wave` gives them), `starts[i]` its first
        sample, `carry_tail` the last `halo` samples (in the blocks' form)
        of the block before the wave, on shard 0's owner (None when the
        wave starts the capture). One ring `ppermute` hands each shard the
        tail of the shard before it; shard 0 receives the wave's last tail,
        which is the next wave's carry. Returns (each local shard's
        (outputs, c of its last output), None for another process's shard;
        the next wave's carry on shard 0's owner, else None)."""
        mesh = self.mesh
        devs = mesh.time_devices
        ndev = len(devs)
        like = next(x for x in chunks if x is not None)
        per = 2 if like.dtype == torch.uint8 else 1
        tails = [None if x is None else x[-per * self.halo:] for x in chunks]
        halos = ppermute(tails, [(i, (i + 1) % ndev) for i in range(ndev)], devs,
                         mesh.time_ranks)
        carry, halos[0] = halos[0], carry_tail
        outs = [None] * ndev
        for i, (s, x, h) in enumerate(zip(starts, chunks, halos)):
            if x is None:
                continue
            if s == 0:
                first = DdcFmStream(self.fe, x.device, dtype)
                outs[i] = (first.step(x, 0), first.c_prev)
            else:
                outs[i] = self._chunk(x, h, s, dtype)
        return outs, carry

    def process(self, source, block_size: int, dtype=torch.complex64
                ) -> tuple[np.ndarray, int]:
        """Wave-parallel run over the whole source; the outputs (on the
        host) and the output rate of `DdcFm.process` on the same blocks.
        On a mesh that spans processes each process reads only its own
        blocks, and every process returns the whole output."""
        if block_size < self.halo:
            raise ValueError(f"block_size {block_size} is shorter than the "
                             f"halo of {self.halo} samples")
        fe = self.fe
        k = fe.ntaps
        mesh = self.mesh
        devs = mesh.time_devices
        ndev = len(devs)
        mine = mesh.local_time
        plan = plan_blocks(source.length, block_size)
        # the whole blocks lead the plan; the waves take all they can
        n_waves = sum(e - s == block_size for s, e in plan) // ndev
        waves = [plan[w * ndev:(w + 1) * ndev] for w in range(n_waves)]
        feed = iter(BlockFeeder(source, device=devs[mine[0]], dtype=dtype,
                                blocks=[wave[i] for wave in waves for i in mine]))
        outs: dict = {}                 # block index -> host output
        carry = None
        for w, wave in enumerate(waves):
            chunks = [None] * ndev
            for i in mine:
                chunks[i] = next(feed)[2].to(devs[i])
            res, carry = self._wave(chunks, [s for s, _ in wave], carry, dtype)
            for i in mine:
                outs[w * ndev + i] = res[i][0].cpu().numpy()

        # the blocks after the last whole wave, sequentially on shard 0's
        # owner, from the last wave's history and c
        rest = plan[n_waves * ndev:]
        if rest:
            c_last = (ppermute([None if r is None else r[1] for r in res],
                               [(ndev - 1, 0)], devs, mesh.time_ranks)[0]
                      if n_waves else None)
            if mesh.is_local(0):
                stream = DdcFmStream(fe, devs[0], dtype)
                if n_waves:
                    per = 2 if carry.dtype == torch.uint8 else 1
                    stream.hist = carry[-per * (k - 1):].clone()
                    stream.c_prev = c_last
                for b, (s, _, x) in enumerate(BlockFeeder(source, device=devs[0],
                                                          dtype=dtype, blocks=rest)):
                    outs[n_waves * ndev + b] = stream.step(x, s).cpu().numpy()
        outs = gather_host(mesh, outs)
        return np.concatenate([outs[b] for b in sorted(outs)]), fe.out_rate
