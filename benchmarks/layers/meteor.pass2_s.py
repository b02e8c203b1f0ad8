"""PSK decoder, Meteor: seconds of `pass2` (the host replay of the arming
and countdown walk, each frame's window to the host and its correlation) a
decode, from the port's own CUDA-event stage spans, averaged over the
window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["pass2"] for r in ctx["records"]
            if "pass2" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
