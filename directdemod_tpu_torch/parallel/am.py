"""The blocked AM envelope over the `time` shards of a mesh.

Port of `directdemod_tpu/parallel/am.py:1-52`. The reference's AM demod
runs on each 240,000-sample block with no carried state (ref
decode_noaa.py:644-653), so the blocks are independent: they are dealt over
the shards, each shard runs the batched-FFT Hilbert envelope
(`ops.am.envelope`) on its rows, and nothing passes between shards. The
ragged last block (its own FFT length) runs on the first shard, as in the
sequential `ops.am.envelope_blocked`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import am as am_ops
from .mesh import Mesh, gather_host


def sharded_envelope_blocked(mesh: Mesh, x: np.ndarray, block: int) -> np.ndarray:
    """`ops.am.envelope_blocked` over `mesh`'s `time` shards (host in and
    out; on a mesh that spans processes each process runs its own shards'
    rows, shard 0's owner the ragged block, and every process returns the
    whole envelope)."""
    devs = mesh.time_devices
    ndev = len(devs)
    n = len(x)
    if n == 0:
        return np.zeros(0, dtype=np.float32)
    x = torch.as_tensor(np.ascontiguousarray(x))
    nfull = n // block
    parts = {}
    if nfull:
        rows = x[: nfull * block].reshape(nfull, block)
        pad_rows = (-nfull) % ndev
        if pad_rows:
            # copies of row 0 (all-zero rows would put NaNs through the
            # normalized FFT chain), dropped below
            rows = torch.cat([rows, rows[:1].expand(pad_rows, -1)])
        per = rows.shape[0] // ndev
        for i in mesh.local_time:
            parts[i] = am_ops.envelope(rows[i * per:(i + 1) * per].to(devs[i])).cpu().numpy()
    if n - nfull * block and mesh.is_local(0):
        parts[ndev] = am_ops.envelope(x[nfull * block:].to(devs[0])).cpu().numpy()
    parts = gather_host(mesh, parts)
    out = []
    if nfull:
        out.append(np.concatenate([parts[i] for i in range(ndev)])[:nfull].reshape(-1))
    if ndev in parts:
        out.append(parts[ndev])
    return np.concatenate(out)
