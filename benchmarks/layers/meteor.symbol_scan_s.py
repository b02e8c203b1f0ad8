"""PSK decoder, Meteor: seconds of `symbol_scan` (K3's QPSK scan over every
block) a decode, from the port's own CUDA-event stage spans, averaged over
the window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["symbol_scan"] for r in ctx["records"]
            if "symbol_scan" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
