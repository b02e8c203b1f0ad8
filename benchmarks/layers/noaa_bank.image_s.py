"""NOAA bank decoder: seconds of the `image` stage a decode (every useful
channel's image: band-pass, envelope and line groups on the card, the
calibration walk on the host, a channel after another), from the port's
own CUDA-event stage spans (`NoaaBankDecoder.stage_seconds`), averaged
over the window's decodes. None when no decode timed that stage."""

STAGE = "image"


def read(ctx):
    vals = [r["stage_seconds"][STAGE] for r in ctx["records"]
            if STAGE in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
