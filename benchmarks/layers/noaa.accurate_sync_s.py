"""NOAA decoder: seconds of the `accurate_sync` stage a decode, from the
port's own CUDA-event stage spans, averaged over the window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["accurate_sync"] for r in ctx["records"]
            if "accurate_sync" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
