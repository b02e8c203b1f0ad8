"""AFSK decoder: seconds of the `bit_sync` stage a decode (band-pass,
correlator bank, edge correlation, forward-window extrema and K2, the
events to the host), from the port's own CUDA-event stage spans, averaged
over the window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["bit_sync"] for r in ctx["records"]
            if "bit_sync" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
