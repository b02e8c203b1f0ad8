"""NOAA decoder: seconds a decode of the image stage's loop over
line-length groups (a gather, a resample, a median and two copies to the
host a group), from the program's span `noaa.image.lines.groups` (one a
channel's image: three a decode in the bank), summed over the traced
window and divided by its decodes. None when the trace holds no such
span."""

SPAN = "noaa.image.lines.groups"


def read(ctx):
    ev = ctx["events"]
    if ev is None or not ctx["records"]:
        return None
    got = [(max(s, ev.lo), min(e, ev.hi)) for s, e, n in ev.stages if n == SPAN]
    if not got:
        return None
    return sum(max(e - s, 0.0) for s, e in got) * 1e-6 / len(ctx["records"])
