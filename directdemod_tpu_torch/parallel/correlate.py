"""The NOAA sync search over the `time` shards of a mesh.

Port of `directdemod_tpu/parallel/correlate.py:1-100` (the sync search of
ref decode_noaa.py:659-767): each shard holds a contiguous span of the
envelope, takes half a needle of halo from each neighbour (two
`mesh.ppermute`s), computes the normalized correlation of its span
(`ops.correlate.norm_correlate`), and gives its top-k and bottom-k values to
an `mesh.all_gather` from which every shard takes the global adaptive
threshold. Peak grouping runs on the host (`ops.peaks.group_peaks`). On a
mesh that spans processes each process correlates its own shards, the
halos and extremes cross processes, and the correlation is gathered so
that every process groups the same peaks.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops import correlate as corr_ops, peaks as peaks_ops
from .mesh import Mesh, all_gather, gather_host, ppermute

log = logging.getLogger(__name__)

# The JAX package's bound on the above-threshold samples the sharded search
# keeps (`directdemod_tpu/ops/peaks.py:33`).
CANDIDATE_CAP = 1 << 18


def _sharded_corr(mesh: Mesh, x: torch.Tensor, needle: torch.Tensor,
                  k_top: int) -> tuple[dict, np.ndarray, np.ndarray]:
    """x: (ndev * per,) float32 on the host -> (each local shard's
    correlation on the host, by shard; the global top-k and bottom-k
    values)."""
    devs, ranks = mesh.time_devices, mesh.time_ranks
    ndev = len(devs)
    halo = needle.shape[0] // 2 + 1
    locs = [part.to(d) if mesh.is_local(i) else None
            for i, (part, d) in enumerate(zip(x.reshape(ndev, -1), devs))]
    fwd = [(i, i + 1) for i in range(ndev - 1)]          # left nbr's tail
    bwd = [(i, i - 1) for i in range(1, ndev)]           # right nbr's head
    from_left = ppermute([None if loc is None else loc[-halo:] for loc in locs],
                         fwd, devs, ranks)
    from_right = ppermute([None if loc is None else loc[:halo] for loc in locs],
                          bwd, devs, ranks)
    cors, tops, bots = {}, [None] * ndev, [None] * ndev
    for i in mesh.local_time:
        ext = torch.cat([from_left[i], locs[i], from_right[i]])
        cor = corr_ops.norm_correlate(ext, needle.to(devs[i]))[halo:halo + locs[i].shape[0]]
        cors[i] = cor.cpu().numpy()
        tops[i] = torch.topk(cor, k_top).values
        bots[i] = -torch.topk(-cor, k_top).values
    # every shard reduces the gathered extremes alike; the first local
    # shard's are read
    first = mesh.local_time[0]
    g_top = torch.topk(all_gather(tops, devs, ranks)[first].reshape(-1), k_top).values
    g_bot = -torch.topk(-all_gather(bots, devs, ranks)[first].reshape(-1), k_top).values
    return cors, g_top.cpu().numpy(), g_bot.cpu().numpy()


def sharded_find_sync_peaks(mesh: Mesh, x: np.ndarray, needle: np.ndarray,
                            samp_rate: float, wiggle: float,
                            min_dist_s: float) -> np.ndarray:
    """`ops.peaks.find_sync_peaks` of the normalized correlation of the
    host signal `x` with `needle`, over `mesh`'s `time` shards: `x` is
    padded to a whole number of samples a shard; returns the global sync
    start indices."""
    ndev = mesh.shape["time"]
    n = len(x)
    per = -(-n // ndev)
    xp = np.pad(np.asarray(x, np.float32), (0, per * ndev - n))
    k_top = int(2 * (n / samp_rate)) + 2
    cors, g_top, g_bot = _sharded_corr(
        mesh, torch.from_numpy(xp), torch.as_tensor(needle, dtype=torch.float32),
        k_top)
    # the threshold of ops/peaks.adaptive_threshold from the gathered extremes
    avg_top = float(np.sum(g_top) / k_top)
    avg_bot = float(np.sum(g_bot) / k_top)
    thr = avg_top - wiggle * (avg_top - avg_bot)
    cors = gather_host(mesh, cors)
    cor = np.concatenate([cors[i] for i in range(ndev)])[:n]
    idx = np.flatnonzero(cor > thr)
    if len(idx) > CANDIDATE_CAP:
        log.warning(
            "sync candidate cap bound: %d above-threshold samples, keeping "
            "the first %d — threshold likely collapsed (noise-only capture?)",
            len(idx), CANDIDATE_CAP)
        idx = idx[:CANDIDATE_CAP]
    if len(idx) == 0:
        return np.empty(0, dtype=np.int64)
    grouped = peaks_ops.group_peaks(idx, cor[idx], min_dist_s * samp_rate)
    return np.sort(grouped - len(needle) // 2)
