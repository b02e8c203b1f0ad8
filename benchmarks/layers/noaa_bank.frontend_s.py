"""NOAA bank decoder: seconds of the `fm_frontend` stage a decode (the bank's
front end: one `MultiDdcFm` stream, every channel's K1 outputs left on the
card), from the port's own CUDA-event stage spans
(`NoaaBankDecoder.stage_seconds`), averaged over the window's decodes.
None when no decode timed that stage."""

STAGE = "fm_frontend"


def read(ctx):
    vals = [r["stage_seconds"][STAGE] for r in ctx["records"]
            if STAGE in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
