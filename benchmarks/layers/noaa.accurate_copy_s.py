"""NOAA decoder: seconds a decode of the accurate sync's blocking copies
(one a batch of windows: the detections, positions, maxima and time syncs
to the host, which waits there for the batch's filters and correlations),
from the program's span `noaa.accurate_sync.copy` (inside
`noaa.accurate_sync`, in the bank inside `noaa_bank.accurate_sync`),
summed over the traced window and divided by its decodes. None when the
trace holds no such span."""

SPAN = "noaa.accurate_sync.copy"


def read(ctx):
    ev = ctx["events"]
    if ev is None or not ctx["records"]:
        return None
    got = [(max(s, ev.lo), min(e, ev.hi)) for s, e, n in ev.stages if n == SPAN]
    if not got:
        return None
    return sum(max(e - s, 0.0) for s, e in got) * 1e-6 / len(ctx["records"])
