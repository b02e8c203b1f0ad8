"""The NOAA sync search over the `time` shards of a mesh.

Port of `directdemod_tpu/parallel/correlate.py:1-100` (the sync search of
ref decode_noaa.py:659-767): each shard holds a contiguous span of the
envelope, takes half a needle of halo from each neighbour (two
`mesh.ppermute`s), computes the normalized correlation of its span
(`ops.correlate.norm_correlate`), and gives its top-k and bottom-k values to
an `mesh.all_gather` from which every shard takes the global adaptive
threshold. Peak grouping runs on the host (`ops.peaks.group_peaks`).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops import correlate as corr_ops, peaks as peaks_ops
from .mesh import Mesh, all_gather, ppermute

log = logging.getLogger(__name__)

# The JAX package's bound on the above-threshold samples the sharded search
# keeps (`directdemod_tpu/ops/peaks.py:33`).
CANDIDATE_CAP = 1 << 18


def _sharded_corr(mesh: Mesh, x: torch.Tensor, needle: torch.Tensor,
                  k_top: int) -> tuple[list, np.ndarray, np.ndarray]:
    """x: (ndev * per,) float32 on the host -> (each shard's correlation,
    the global top-k and bottom-k values)."""
    devs = mesh.time_devices
    ndev = len(devs)
    halo = needle.shape[0] // 2 + 1
    locs = [part.to(d) for part, d in zip(x.reshape(ndev, -1), devs)]
    fwd = [(i, i + 1) for i in range(ndev - 1)]          # left nbr's tail
    bwd = [(i, i - 1) for i in range(1, ndev)]           # right nbr's head
    from_left = ppermute([loc[-halo:] for loc in locs], fwd, devs)
    from_right = ppermute([loc[:halo] for loc in locs], bwd, devs)
    cors, tops, bots = [], [], []
    for loc, lpad, rpad, d in zip(locs, from_left, from_right, devs):
        ext = torch.cat([lpad, loc, rpad])
        cor = corr_ops.norm_correlate(ext, needle.to(d))[halo:halo + loc.shape[0]]
        cors.append(cor)
        tops.append(torch.topk(cor, k_top).values)
        bots.append(-torch.topk(-cor, k_top).values)
    # every shard reduces the gathered extremes alike; shard 0's are read
    g_top = torch.topk(all_gather(tops, devs)[0].reshape(-1), k_top).values
    g_bot = -torch.topk(-all_gather(bots, devs)[0].reshape(-1), k_top).values
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
    cor = torch.cat([c.cpu() for c in cors]).numpy()[:n]
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
