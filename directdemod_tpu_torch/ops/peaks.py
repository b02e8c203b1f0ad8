"""Peak detection: the APT sync search and the AFSK lookahead walk.

Port of `directdemod_tpu/ops/peaks.py:36-443`.

The APT sync part: the top-k adaptive threshold, the candidates above it,
and the min-distance grouping that keeps the maximum of each group. The
device does the dense work; the sequential grouping walk runs on the host
over the sparse candidate list. The reference's two-stage blocked top-k and
its fixed candidate slots were workarounds for its device; `torch.topk` and
`torch.nonzero` take any size.

The lookahead part (`lookahead_peaks`, ref peakdetect.py:141-254): the
forward-window extrema are two stride-1 max pools; the alternating max/min
walk over them is K2 (`lookahead_walk`), the CUDA kernel
`csrc/lookahead_walk.cu` (a chunk-speculative walk: chunks walked in
parallel from the two states a fire resets to, stitched in order) for
tensors on a CUDA device and its plain version `lookahead_walk_plain` (the
sequential walk) for tensors on the CPU; any other device raises, and
there is no fallback from the kernel to the plain version. Events are int64
index tensors sized so that they cannot overflow, so the reference's
float32 index packing, its event cap and its dense overflow fallback are
not ported.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

# Number of K2 kernel launches in this process (the plain version does not
# count).
LAUNCHES = 0


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


# --------------------------------------------------------------------- lookahead peaks

def forward_window_extrema(y: torch.Tensor, w: int
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """fwd_max[i] = max(y[i:i+w]), fwd_min[i] = min(y[i:i+w]) for
    i <= len(y) - w (exact: a max pool picks one of its inputs)."""
    y3 = y.reshape(1, 1, -1)
    return (F.max_pool1d(y3, w, stride=1).reshape(-1),
            -F.max_pool1d(-y3, w, stride=1).reshape(-1))


def _check_walk(y: torch.Tensor, fmax: torch.Tensor, fmin: torch.Tensor,
                delta: float) -> int:
    """Validate K2's argument contract; returns the walk length."""
    for name, t in (("y", y), ("fmax", fmax), ("fmin", fmin)):
        if t.dtype != torch.float32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D float32 tensor")
        if t.device != y.device:
            raise ValueError(f"{name} is on {t.device}, y on {y.device}")
        if t.shape[0] != y.shape[0]:
            raise ValueError(f"{name} holds {t.shape[0]} samples, y {y.shape[0]}")
    if not float(delta) >= 0.0:
        raise ValueError(f"delta must be >= 0, got {delta}")
    return int(y.shape[0])


def lookahead_walk_plain(y: torch.Tensor, fmax: torch.Tensor,
                         fmin: torch.Tensor, delta: float
                         ) -> tuple[torch.Tensor, ...]:
    """K2's contract as a plain Python loop, line for line the body of
    `directdemod_tpu/ops/peaks.py::_lookahead_scan`. The thresholds
    mx - delta and mn + delta are float32 as in the kernel: a finite mx is
    always y[mxpos], so they are read from y -/+ delta computed once in
    float32. Returns (index, position, value, is_max) tensors on y's
    device, one entry per fire, in index order."""
    limit = _check_walk(y, fmax, fmin, delta)
    d = torch.tensor(float(delta), dtype=torch.float32, device=y.device)
    ys, fxs, fns = y.tolist(), fmax.tolist(), fmin.tolist()
    ymd, ypd = (y - d).tolist(), (y + d).tolist()
    isfinite = math.isfinite
    inf = math.inf
    mx, mn, mxpos, mnpos = -inf, inf, 0, 0
    mx_thr = mn_thr = math.nan
    events = []
    for i in range(limit):
        yi = ys[i]
        if yi > mx:
            mx, mxpos, mx_thr = yi, i, ymd[i]
        if yi < mn:
            mn, mnpos, mn_thr = yi, i, ypd[i]
        if yi < mx_thr and isfinite(mx) and fxs[i] < mx:
            events.append((i, mxpos, mx, True))
            mx = mn = inf
        elif yi > mn_thr and isfinite(mn) and fns[i] > mn:
            events.append((i, mnpos, mn, False))
            mx = mn = -inf
    idx, pos, val, is_max = zip(*events) if events else ((),) * 4
    dev = y.device
    return (torch.tensor(idx, dtype=torch.int64, device=dev),
            torch.tensor(pos, dtype=torch.int64, device=dev),
            torch.tensor(val, dtype=torch.float32, device=dev),
            torch.tensor(is_max, dtype=torch.bool, device=dev))


# Samples a chunk of K2's speculative walks (`csrc/lookahead_walk.cu`).
# Pass 1 costs about CHUNK steps of one walker and the stitch a few fires a
# chunk, so the best length balances the two: chosen on the card by timing
# the AFSK decode's whole walk at several lengths (PERF.md).
CHUNK = 16384
# Samples between the (mx, mn) records of a speculative walk (the kernel's Q).
_CHECKPOINT = 32

_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("lookahead_walk")
        fn = lib.lookahead_walk_launch
        fn.argtypes = ([ctypes.c_void_p] * 3
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_longlong]
                       + [ctypes.c_void_p] * 15 + [ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (or find) and load the K2 kernel library."""
    _kernel_lib()


def lookahead_walk(y: torch.Tensor, fmax: torch.Tensor, fmin: torch.Tensor,
                   delta: float, chunk: int | None = None,
                   stats: dict | None = None) -> tuple[torch.Tensor, ...]:
    """K2 on the tensors' device: the walk over all of `y` (fmax, fmin its
    forward-window extrema at the same indices), the CUDA kernel on a CUDA
    device, the plain version on the CPU. Returns (index int64, position
    int64, value float32, is_max bool) tensors, one entry per fire.

    On the card the walk is chunk-speculative, `chunk` samples a chunk
    (default `CHUNK`); the events do not depend on it. Its scratch holds
    about 21 bytes a sample. A dict passed as `stats` receives, on the
    card, "chunk", "chunks", and per chunk "stitch_steps" (the samples the
    stitch walked) and "met" (whether it met a speculative walk), as device
    tensors."""
    global LAUNCHES
    if chunk is not None and int(chunk) < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if y.device.type == "cpu":
        return lookahead_walk_plain(y, fmax, fmin, delta)
    if y.device.type != "cuda":
        raise ValueError(f"lookahead_walk runs on cuda or cpu, not {y.device}")
    limit = _check_walk(y, fmax, fmin, delta)
    lib = _kernel_lib()
    L = max(1, min(int(chunk or CHUNK), limit))
    n_chunks = -(-limit // L)
    walks, slots = 2 * n_chunks, 2 * n_chunks * (L // 2 + 2)
    checkpoints = walks * max(1, L // _CHECKPOINT)
    cap = limit // 2 + 2          # fires never follow fires at the next index
    dev = y.device

    def empty(n, dtype):
        return torch.empty(n, dtype=dtype, device=dev)
    # scratch, in the entry point's order: each walk's events (index,
    # position, value, kind), their counts, its exit values and positions,
    # its checkpoints; each chunk's record and the stitch's steps
    sp = (empty(slots, torch.int64), empty(slots, torch.int64),
          empty(slots, torch.float32), empty(slots, torch.uint8),
          empty(walks, torch.int64), empty(2 * walks, torch.float32),
          empty(2 * walks, torch.int64), empty(2 * checkpoints, torch.float32),
          empty(7 * n_chunks, torch.int64), empty(n_chunks, torch.int64))
    idx = empty(cap, torch.int64)
    pos = empty(cap, torch.int64)
    val = empty(cap, torch.float32)
    is_max = empty(cap, torch.bool)
    count = empty(1, torch.int64)
    err = lib.lookahead_walk_launch(
        y.data_ptr(), fmax.data_ptr(), fmin.data_ptr(), limit, float(delta), L,
        *(t.data_ptr() for t in sp), idx.data_ptr(), pos.data_ptr(),
        val.data_ptr(), is_max.data_ptr(), count.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lookahead_walk kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    if stats is not None:
        stats.update(chunk=L, chunks=n_chunks, stitch_steps=sp[9],
                     met=sp[8].view(n_chunks, 7)[:, 0] >= 0)
    k = int(count.item())
    return idx[:k], pos[:k], val[:k], is_max[:k]


def lookahead_events(y: torch.Tensor, lookahead: int, delta: float = 0.0
                     ) -> tuple[torch.Tensor, ...]:
    """The walk of `lookahead_peaks` on y's device: forward-window extrema,
    then K2 over y[:n - lookahead] (the reference iterates y[:-lookahead]).
    y is walked in float32, as the TPU kernel walks it. Needs
    n > lookahead >= 1."""
    limit = int(y.shape[0]) - lookahead
    y = y.float().contiguous()
    fmax, fmin = forward_window_extrema(y, lookahead)
    return lookahead_walk(y[:limit], fmax[:limit].contiguous(),
                          fmin[:limit].contiguous(), delta)


def unpack_lookahead_events(events, lookahead: int, n: int
                            ) -> tuple[tuple[np.ndarray, np.ndarray],
                                       tuple[np.ndarray, np.ndarray]]:
    """Host split of the walk's events into ((max positions, max values),
    (min positions, min values)), replaying the reference's end-of-signal
    break (the events up to the first with index + lookahead >= n) and its
    pop of the first event (ref peakdetect.py:196-254)."""
    idx, pos, val, is_max = (t.cpu().numpy() for t in events)
    stop = np.flatnonzero(idx + lookahead >= n)
    keep = slice(1, stop[0] + 1 if len(stop) else len(idx))
    pos, val, is_max = pos[keep], val[keep], is_max[keep]
    return ((pos[is_max], val[is_max]), (pos[~is_max], val[~is_max]))


def lookahead_peaks(y: torch.Tensor, lookahead: int, delta: float = 0.0
                    ) -> tuple[list, list]:
    """Alternating max/min peak picking with lookahead confirmation,
    matching `peakdetect` (ref peakdetect.py:141-254). Returns (max_peaks,
    min_peaks) as [index, value] lists."""
    if lookahead < 1:
        raise ValueError("lookahead must be >= 1")
    n = int(y.shape[0])
    if n <= lookahead:
        return [], []
    mx, mn = unpack_lookahead_events(lookahead_events(y, lookahead, delta),
                                     lookahead, n)
    return ([[int(p), float(v)] for p, v in zip(*mx)],
            [[int(p), float(v)] for p, v in zip(*mn)])
