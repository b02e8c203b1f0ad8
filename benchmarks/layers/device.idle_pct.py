"""Device: share of the traced window in which no kernel, copy or memset
ran on the card, in per cent."""


def read(ctx):
    ev = ctx["events"]
    if ev is None or ev.window_s <= 0.0 or ev.busy_s <= 0.0:
        return None
    return 100.0 * (1.0 - ev.busy_s / ev.window_s)
