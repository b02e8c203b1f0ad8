"""PSK decoder: seconds a decode of the front end's IIR low-pass
(`lp.apply`, once a block), from the program's span
`psk.frontend.lowpass` (a `torch.profiler` range, on the trace's clock),
summed over the traced window and divided by its decodes. None when the
trace holds no such span."""

SPAN = "psk.frontend.lowpass"


def read(ctx):
    ev = ctx["events"]
    if ev is None or not ctx["records"]:
        return None
    got = [(max(s, ev.lo), min(e, ev.hi)) for s, e, n in ev.stages if n == SPAN]
    if not got:
        return None
    return sum(max(e - s, 0.0) for s, e in got) * 1e-6 / len(ctx["records"])
