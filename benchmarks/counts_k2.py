"""Bytes, operations and least time of kernel K2, the lookahead peak walk
(`directdemod_tpu_torch/ops/peaks.py::lookahead_walk`,
`csrc/lookahead_walk.cu`), from the samples it walks and the events it
fires. The peaks are `benchmarks/counts.py`'s."""
from __future__ import annotations

from benchmarks.counts import least_seconds

# the kernels of one K2 launch, as a trace names them
KERNELS = ("k2_speculative_walks", "k2_stitch", "k2_gather")


def k2_walk(n_samples: int, n_events: int) -> tuple[int, int]:
    """(bytes, operations) of one walk: 12 B read a sample walked (y, fmax
    and fmin, float32 each), 21 B written an event (index and position,
    int64; value, float32; kind, one byte); about 6 float32 operations a
    sample (an estimate: the two compares and selects of the extremes, the
    threshold's subtract and compare, the fire's compares against fmax and
    fmin)."""
    return 12 * n_samples + 21 * n_events, 6 * n_samples


def k2_least_seconds(n_samples: int, n_events: int) -> float:
    return least_seconds(*k2_walk(n_samples, n_events))
