"""Exact IIR filtering (and zero-phase filtfilt) over the `time` shards of a
mesh.

Port of `directdemod_tpu/parallel/iir.py:1-157`. The one-device engine
(`ops.iir.IirFilter`) evaluates each biquad as a zero-state convolution plus
a boundary-state recurrence over fixed blocks. The shards use the same
linearity one level up: each filters its span from a ZERO state, and the
true incoming state s_in adds a rank-2 correction afterwards,

    y_local(t) += s_in . (C A^t)          (zero-input response)
    s_out       = s_in . (A^T)^n + g      (g = the shard's zero-state end state)

so the only data between shards is each section's 2-vector `g`: one
`mesh.all_gather` of (ndev, 2) a biquad, after which every shard folds the
`g` of the shards before it through host powers of A (`_mpow`). The result
is the sequential cascade's up to the association of floating-point sums.
The NOAA image stage on a mesh runs its 400-4400 Hz band-pass (ref
decode_noaa.py:274) forward and backward so, the filtfilt padding and the
ragged tail by a sequential epilogue from the carried state.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.iir import IirFilter, _biquad_state_space
from .mesh import Mesh, all_gather, gather_host


@lru_cache(maxsize=32)
def _shard_consts(filt: IirFilter, n_local: int) -> list:
    """Each section's host constants for an n_local-sample shard: W
    (n_local, 2), the rows C A^t (the zero-input response basis), and
    M = (A^T)^n_local."""
    out = []
    for s in filt.sos:
        A, B, C, D = _biquad_state_space(s)
        # rows C A^t by doubling: W_{2k} = [W_k ; W_k A^k]
        W = C[None, :].copy()
        Ak = A.copy()
        while W.shape[0] < n_local:
            W = np.concatenate([W, W @ Ak])
            Ak = Ak @ Ak
        out.append((W[:n_local], np.linalg.matrix_power(A, n_local).T))
    return out


@lru_cache(maxsize=32)
def _mpow(filt: IirFilter, n_local: int, ndev: int) -> list:
    """Powers M^0..M^ndev of each section's shard transition matrix."""
    pows = []
    for _, M in _shard_consts(filt, n_local):
        p = [np.eye(2)]
        for _ in range(ndev):
            p.append(p[-1] @ M)
        pows.append(np.stack(p))
    return pows


def _sharded_lfilter(mesh: Mesh, filt: IirFilter, x2d: torch.Tensor,
                     zi: np.ndarray) -> tuple[dict, dict]:
    """x2d: (ndev, n_local) on the host, row i for time shard i; zi: the
    initial state (2 * n_sections,) of the whole stream. Returns (each
    local shard's output on the host, by shard; the last shard's end state
    under the key ndev, where that shard is local)."""
    devs, ranks = mesh.time_devices, mesh.time_ranks
    ndev = len(devs)
    mine = mesh.local_time
    n_local = int(x2d.shape[1])
    L = min(filt.block, max(16, n_local))
    np_last = n_local - (-(-n_local // L) - 1) * L
    sec = _shard_consts(filt, n_local)
    pows = _mpow(filt, n_local, ndev)
    ys = {pos: x2d[pos].to(devs[pos]) for pos in mine}
    rdt = x2d.dtype
    consts = {pos: filt._constants(L, np_last, rdt, y.device) for pos, y in ys.items()}
    zis = np.asarray(zi, dtype=np.float64).reshape(filt.n_sections, 2)
    z_last = []
    for i in range(filt.n_sections):
        parts = {pos: filt._apply_section(y, torch.zeros(2, dtype=rdt, device=y.device),
                                          consts[pos][i], np_last)
                 for pos, y in ys.items()}
        gathered = all_gather([parts[pos][1] if pos in parts else None
                               for pos in range(ndev)], devs, ranks)   # (ndev, 2) each
        for pos, (y0, g) in parts.items():
            def t(a, d=y0.device):
                return torch.as_tensor(a, dtype=rdt, device=d)
            gg = gathered[pos]
            # s_in = zi . M^pos + sum_{j<pos} g_j . M^(pos-1-j)
            s_in = t(zis[i]) @ t(pows[i][pos])
            for j in range(pos):
                s_in = s_in + gg[j] @ t(pows[i][pos - 1 - j])
            ys[pos] = y0 + t(sec[i][0]) @ s_in
            if pos == ndev - 1:
                z_last.append((s_in @ t(sec[i][1]) + g).cpu())
    out = {pos: y.cpu().numpy() for pos, y in ys.items()}
    if z_last:
        out[ndev] = torch.stack(z_last).reshape(-1).numpy()
    return out


def sharded_lfilter(mesh: Mesh, filt: IirFilter, x: np.ndarray, zi: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Exact lfilter of a long 1-D host signal over `mesh`'s `time` shards,
    the ragged tail (len(x) % ndev samples) sequentially from the carried
    state. Returns (y, final_state) on the host; on a mesh that spans
    processes each process filters its own shards, the shards' outputs and
    the end state are gathered, and every process runs the tail."""
    ndev = mesh.shape["time"]
    n = len(x)
    n_local = n // ndev
    main = n_local * ndev
    dev0 = mesh.time_devices[mesh.local_time[0]]
    x = torch.as_tensor(np.ascontiguousarray(x))
    if n_local == 0:
        y, zf = filt.apply(x.to(dev0), torch.as_tensor(zi, dtype=x.dtype, device=dev0))
        return y.cpu().numpy(), zf.cpu().numpy()
    parts = gather_host(mesh, _sharded_lfilter(mesh, filt,
                                               x[:main].reshape(ndev, n_local), zi))
    zf = parts[ndev]
    y = torch.from_numpy(np.concatenate([parts[pos] for pos in range(ndev)]))
    if main < n:
        yt, zt = filt.apply(x[main:].to(dev0),
                            torch.as_tensor(zf, dtype=x.dtype, device=dev0))
        y = torch.cat([y, yt.cpu()])
        zf = zt.cpu().numpy()
    return y.numpy(), zf


def sharded_zero_phase(mesh: Mesh, filt: IirFilter, x: np.ndarray) -> np.ndarray:
    """scipy filtfilt's 'pad' mode (ref filters.py:73) over `mesh`'s `time`
    shards; `ops.iir.IirFilter.zero_phase` up to the association of sums."""
    x = np.asarray(x)
    b, a = filt.ba()
    padlen = 3 * max(len(b), len(a))
    n = len(x)
    if n <= padlen:
        raise ValueError(f"input too short for filtfilt: {n} <= {padlen}")
    head = 2 * x[0] - x[1:padlen + 1][::-1]
    tail = 2 * x[-1] - x[-padlen - 1:-1][::-1]
    ext = np.concatenate([head, x, tail])
    zi = filt.initial_state_step(
        torch.float64 if x.dtype == np.float64 else torch.float32).numpy()
    yf, _ = sharded_lfilter(mesh, filt, ext, zi * ext[0])
    yr = yf[::-1]
    yb, _ = sharded_lfilter(mesh, filt, yr, zi * yr[0])
    return yb[::-1][padlen:padlen + n]
