"""Host runtime: seconds a decode of Python's garbage collections, from the
program's span `host.gc` (each collection while a profiler records, a
child of whatever range is open), summed over the traced window and
divided by its decodes; 0 where none fell in the window. None when the
program does not range its collections (it names no ranges:
`models.stages.span_names`)."""

SPAN = "host.gc"


def read(ctx):
    ev = ctx["events"]
    if ev is None or not ctx["records"]:
        return None
    from directdemod_tpu_torch.models import stages
    if not hasattr(stages, "span_names"):
        return None
    got = [(max(s, ev.lo), min(e, ev.hi)) for s, e, n in ev.stages if n == SPAN]
    return sum(max(e - s, 0.0) for s, e in got) * 1e-6 / len(ctx["records"])
