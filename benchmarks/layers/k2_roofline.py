"""Kernel K2 (`ops/peaks.py::lookahead_walk`, `csrc/lookahead_walk.cu`):
its least time over its device time in the traced window, in per cent.
The least time counts 12 B a sample walked, 21 B an event and about 6
fp32 operations a sample (`benchmarks/counts_k2.py`) for the program's
counters `afsk.bit_sync.samples` and `afsk.bit_sync.events`, the profiler
session's tally over the same window; the device time is every kernel of
K2's three (`k2_speculative_walks`, `k2_stitch`, `k2_gather`) in the
trace. K2 is a dependent chain a chunk, so the share is small; it still
tracks K2's time. None when the trace holds none of those kernels or the
program keeps no such counters."""

SAMPLES = "afsk.bit_sync.samples"
EVENTS = "afsk.bit_sync.events"


def read(ctx):
    ev = ctx["events"]
    if ev is None:
        return None
    from benchmarks.counts_k2 import KERNELS, k2_least_seconds
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    t = sum(ev.kernel_seconds(k)[0] for k in KERNELS)
    if t <= 0.0 or tally.get(SAMPLES, 0) <= 0 or EVENTS not in tally:
        return None
    return 100.0 * k2_least_seconds(tally[SAMPLES], tally[EVENTS]) / t
