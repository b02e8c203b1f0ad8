"""NOAA decoder: seconds of the `image` stage a decode, from the port's
own CUDA-event stage spans (`NoaaDecoder.stage_seconds`), averaged over
the window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["image"] for r in ctx["records"]
            if "image" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
