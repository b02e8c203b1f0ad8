"""NOAA decoder: seconds of the `crude_sync` stage a decode (the
envelope, the needles' correlation, the candidates above the threshold
and their grouping on the host), from the port's own CUDA-event stage
spans (`NoaaDecoder.stage_seconds`), averaged over the window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["crude_sync"] for r in ctx["records"]
            if "crude_sync" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
