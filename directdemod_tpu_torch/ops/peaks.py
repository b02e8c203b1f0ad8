"""Peak detection and grouping for the APT sync search.

Port of the sync part of `directdemod_tpu/ops/peaks.py:36-155`: the top-k
adaptive threshold, the candidates above it, and the min-distance grouping
that keeps the maximum of each group. The device does the dense work; the
sequential grouping walk runs on the host over the sparse candidate list.
The reference's two-stage blocked top-k and its fixed candidate slots were
workarounds for its device; `torch.topk` and `torch.nonzero` take any size.
"""
from __future__ import annotations

import numpy as np
import torch


def top_k_exact(x: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k values of the last axis, sorted descending."""
    return torch.topk(x, k, dim=-1).values


def adaptive_threshold(cor: torch.Tensor, samp_rate: float,
                       wiggle: float) -> tuple[torch.Tensor, int]:
    """Peak-height floor along the last axis: mean of the top-k values,
    pulled down by `wiggle` times the top-to-bottom spread, with
    k = int(2 * duration_seconds) + 2. Returns (threshold, k)."""
    n = cor.shape[-1]
    k = int(2 * (n / samp_rate)) + 2
    avg_top = top_k_exact(cor, k).mean(dim=-1)
    avg_bot = (-top_k_exact(-cor, k)).mean(dim=-1)
    return avg_top - wiggle * (avg_top - avg_bot), k


def candidates_above(cor: torch.Tensor, threshold: torch.Tensor
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Host (index, value) pairs where the 1-D `cor` > threshold, in index
    order (int64 indices)."""
    idx = torch.nonzero(cor > threshold).reshape(-1)
    return idx.cpu().numpy(), cor[idx].cpu().numpy()


def group_peaks(indices: np.ndarray, values: np.ndarray,
                min_dist: float) -> np.ndarray:
    """Min-distance grouping keeping the maximum of each run (host walk over
    the sparse candidate list)."""
    best_idx = None
    best_val = None
    out = []
    for i, v in zip(indices.tolist(), values.tolist()):
        if best_idx is not None and (i - best_idx) >= min_dist:
            out.append(best_idx)
            best_idx, best_val = None, None
        if best_val is None or best_val < v:
            best_idx, best_val = i, v
    out.append(best_idx)
    return np.sort(np.asarray([o for o in out if o is not None], dtype=np.int64))


def find_sync_peaks(cor: torch.Tensor, samp_rate: float, needle_len: int,
                    wiggle: float, min_dist_s: float) -> np.ndarray:
    """Full APT peak pipeline on a 1-D correlation; returns sync *start*
    indices (peak centers shifted back by needle_len // 2)."""
    thr, _ = adaptive_threshold(cor, samp_rate, wiggle)
    idx, vals = candidates_above(cor, thr)
    if len(idx) == 0:
        return np.empty(0, dtype=np.int64)
    return np.sort(group_peaks(idx, vals, min_dist_s * samp_rate)
                   - needle_len // 2)


def host_find_sync_peaks(cor: np.ndarray, samp_rate: float, needle_len: int,
                         wiggle: float, min_dist_s: float) -> np.ndarray:
    """find_sync_peaks on a host correlation row (the accurate-sync walk
    over many short windows)."""
    cor = np.asarray(cor)
    n = len(cor)
    k = int(2 * (n / samp_rate)) + 2
    if k >= n:
        top = np.sort(cor)[::-1][:k]
        bot = np.sort(cor)[:k]
    else:
        top = np.partition(cor, n - k)[n - k:]
        bot = np.partition(cor, k - 1)[:k]
    avg_top = float(np.sum(top) / k)
    avg_bot = float(np.sum(bot) / k)
    thr = avg_top - wiggle * (avg_top - avg_bot)
    idx = np.flatnonzero(cor > thr)
    if len(idx) == 0:
        return np.empty(0, dtype=np.int64)
    grouped = group_peaks(idx, cor[idx], min_dist_s * samp_rate)
    return np.sort(grouped - needle_len // 2)
