"""NOAA bank decoder: seconds of the `crude_sync` stage a decode (the
envelope of every channel, the 2C correlation rows, their thresholds, one
grouping of all rows and its copy to the host), from the port's own CUDA-
event stage spans (`NoaaBankDecoder.stage_seconds`), averaged over the
window's decodes. None when no decode timed that stage."""

STAGE = "crude_sync"


def read(ctx):
    vals = [r["stage_seconds"][STAGE] for r in ctx["records"]
            if STAGE in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
