"""Device: share of the traced window, in per cent, in which the card is
idle and no range of the program's is open: the idle time
`ranges.idle_by_range` puts down to no name of `models.stages.span_names()`
(ranges the harness and the drivers open around the program, such as
`bench.decode` and `noaa.get_image`, do not count). At most
`device.idle_pct`. None when the program does not name its ranges, or the
card ran nothing in the window.

A coverage reading, not a speed: it says how much of the card's idle time
the program's ranges leave unexplained, and one more range around any
stretch of host code lowers it with no change to the decode's time. Its
`moves` names `realtime_x` because every per-layer metric must name one;
it moves none, and a fall in it is no gain. Kept under 5 %, it says the
other idle readings (`idle_by_range` by range) account for the idle."""


def read(ctx):
    ev = ctx["events"]
    from benchmarks.ranges import idle_by_range
    from directdemod_tpu_torch.models import stages
    names = getattr(stages, "span_names", None)
    if ev is None or names is None or ev.window_s <= 0.0 or ev.busy_s <= 0.0:
        return None
    return 100.0 * idle_by_range(ev, names())["unranged"] / ev.window_s
