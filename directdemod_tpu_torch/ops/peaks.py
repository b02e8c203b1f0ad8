"""Peak detection: the APT sync search and the AFSK lookahead walk.

Port of `directdemod_tpu/ops/peaks.py:36-443`.

The APT sync part: the top-k adaptive threshold, the candidates above it,
and the min-distance grouping that keeps the maximum of each group. Where
the correlation is a tensor the grouping runs on its device
(`group_peaks_dense`: a sliding-window first argmax, pointer jumping to its
fixed points and a doubled chain of group starts, exactly the walk's
result); where it is a host array (`host_find_sync_peaks`, the mesh's
gathered correlation) the sequential walk `group_peaks` runs over the
sparse candidate list, and it is the plain version the dense one is held
to. The reference's two-stage blocked top-k and its fixed candidate slots
were workarounds for its device; `torch.topk` and `torch.nonzero` take any
size.

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


# int64 key of a sample that is no candidate: below every candidate's
_NO_KEY = -(1 << 63)


def _candidate_keys(cor: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """int64 keys of the (rows, n) float32 `cor` that order its candidates
    as `group_peaks` compares them: the value's order-preserving bits in the
    high half (-0.0 taken as +0.0, which Python's compare holds equal) and
    2^31 - 1 - index in the low half, so that of equal values the earlier
    index is the larger key, as the walk's strict `<` keeps the earlier;
    `_NO_KEY` off the candidates (a candidate is never NaN)."""
    v = torch.where(cor == 0, torch.zeros_like(cor), cor)
    bits = v.view(torch.int32)
    order = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)
    low = 0x7FFFFFFF - torch.arange(cor.shape[-1], device=cor.device)
    key = order * (1 << 32) + low
    return torch.where(cand, key, torch.full_like(key, _NO_KEY))


def _window_first_argmax(key: torch.Tensor, w: int) -> torch.Tensor:
    """Per row of `key` (rows, n), the local index of the largest key over
    [p, p + w] at every p (clipped to the row): blocks of w + 1, their
    prefix and suffix maxima (van Herk / Gil-Werman), one maximum a
    window."""
    rows, n = key.shape
    t = w + 1
    blocks = -(-(n + w) // t)
    pad = torch.full((rows, blocks * t - n), _NO_KEY, dtype=key.dtype,
                     device=key.device)
    b = torch.cat([key, pad], dim=1).view(rows, blocks, t)
    pre = b.cummax(-1).values.view(rows, -1)
    suf = b.flip(-1).cummax(-1).values.flip(-1).view(rows, -1)
    best = torch.maximum(suf[:, :n], pre[:, w:w + n])
    return 0x7FFFFFFF - (best & 0xFFFFFFFF)


# samples a block of the two-level scan in `_next_candidate`
_SCAN_BLOCK = 4096


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] for a 1-D `table`, in `idx`'s shape (`index_select`
    reads int32 indices as they are)."""
    return table.index_select(0, idx.reshape(-1)).view(idx.shape)


def _next_candidate(cand: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(rows, n + 1) table of the first candidate at or after each index
    of a row of the (rows, n) mask, n where there is none: suffix minima in
    blocks of `_SCAN_BLOCK`, then over the blocks (one scan down a whole
    row runs on few threads of the card)."""
    rows, n = cand.shape
    b = _SCAN_BLOCK
    blocks = -(-(n + 1) // b)
    pad = torch.zeros((rows, blocks * b - n), dtype=torch.bool, device=cand.device)
    at = torch.arange(blocks * b, device=cand.device, dtype=dtype)
    val = torch.where(torch.cat([cand, pad], 1), at, n).view(rows, blocks, b)
    inner = val.flip(-1).cummin(-1).values.flip(-1)
    later = inner[:, :, 0].flip(-1).cummin(-1).values.flip(-1)
    later = torch.cat([later[:, 1:], torch.full_like(later[:, :1], n)], 1)
    return torch.minimum(inner, later[:, :, None]).view(rows, -1)[:, :n + 1]


def group_peaks_dense(cor: torch.Tensor, threshold, min_dist: float
                      ) -> torch.Tensor:
    """`group_peaks` of the candidates above `threshold` of each row of the
    float32 `cor` ((rows, n) with one threshold a row, or (n,) with one),
    on `cor`'s device with no host round trip.

    With T = ceil(min_dist) (at least 1, at most n) and W = T - 1, the walk
    from a state b = p, p a candidate, meets no break up to p + W and holds
    there f(p), the first argmax of the candidates over [p, p + W]; every
    later candidate of that window is no greater and lies within W of f(p),
    so the state is that of f(p) seen up to f(p). A group therefore starts
    at a candidate c, is emitted as F*(c), the fixed point of f from c, and
    the next starts at the first candidate at or after F*(c) + T. So: f by
    one sliding-window maximum of `_candidate_keys`; F* by pointer jumping
    F <- F[F] (two hops that do not end on a fixed point move past the
    first window, so a chain holds at most 2 ((n - 1) // T) + 1 hops);
    G(c), that next start, and the chain of starts from the first candidate
    by doubling G (starts lie T apart, so at most (n - 1) // T + 1 of
    them). The rounds are the bounds', fixed.

    Returns an int64 tensor on `cor`'s device, (rows, slots) or (slots,):
    each row's emitted indices in increasing order, equal to the walk's,
    then n in the slots left over. Indices are int32 where they fit."""
    if cor.dtype != torch.float32:
        raise ValueError(f"cor must be float32, got {cor.dtype}")
    one_row = cor.dim() == 1
    c = cor.reshape(1, -1) if one_row else cor
    if c.dim() != 2:
        raise ValueError(f"cor must be (n,) or (rows, n), got {tuple(cor.shape)}")
    rows, n = c.shape
    if n >= 1 << 31:
        raise ValueError(f"rows of {n} samples: at most 2^31 - 1")
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=c.device)
    cand = c > thr.reshape(-1, 1)
    t = min(max(1, math.ceil(min_dist)), max(n, 1))
    m = n + 1                                   # a row of the tables: n + sentinel
    itype = torch.int32 if rows * m < 1 << 31 else torch.int64
    dev = c.device
    off = (torch.arange(rows, device=dev, dtype=itype) * m).reshape(-1, 1)
    sentinel = torch.full((rows, 1), n, device=dev, dtype=itype)

    # F = f on the candidates, the identity elsewhere; global indices
    f = _window_first_argmax(_candidate_keys(c, cand), t - 1).to(itype)
    own = torch.arange(n, device=dev, dtype=itype)
    fs = (torch.cat([torch.where(cand, f, own), sentinel], 1) + off).reshape(-1)
    for _ in range((2 * ((n - 1) // t)).bit_length() if n else 0):
        fs = _take(fs, fs)
    nxt = (_next_candidate(cand, itype) + off).reshape(-1)
    reach = torch.clamp(fs.view(rows, m) - off + t, max=n)
    g = _take(nxt, reach + off).reshape(-1)
    starts = nxt.view(rows, m)[:, :1]
    rounds = ((n - 1) // t).bit_length() if n else 0
    for k in range(rounds):
        starts = torch.cat([starts, _take(g, starts)], 1)
        if k + 1 < rounds:
            g = _take(g, g)
    out = (_take(fs, starts) - off).to(torch.int64)
    return out.reshape(-1) if one_row else out


def find_sync_peaks(cor: torch.Tensor, samp_rate: float, needle_len: int,
                    wiggle: float, min_dist_s: float) -> np.ndarray:
    """Full APT peak pipeline on a 1-D correlation, grouped on its device;
    returns sync *start* indices (peak centers shifted back by
    needle_len // 2)."""
    thr, _ = adaptive_threshold(cor, samp_rate, wiggle)
    slots = group_peaks_dense(cor, thr, min_dist_s * samp_rate).cpu().numpy()
    return slots[slots < cor.shape[-1]] - needle_len // 2


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
