"""NOAA bank decoder: seconds of the `accurate_sync` stage a decode (the
windows of every useful channel, A and B, in shared device batches, and
the reduction of each batch), from the port's own CUDA-event stage spans
(`NoaaBankDecoder.stage_seconds`), averaged over the window's decodes.
None when no decode timed that stage."""

STAGE = "accurate_sync"


def read(ctx):
    vals = [r["stage_seconds"][STAGE] for r in ctx["records"]
            if STAGE in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
