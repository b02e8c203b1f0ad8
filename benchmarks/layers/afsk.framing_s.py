"""AFSK decoder: seconds of the `framing` stage a decode (the baud
windows' means on the card and their copy, then the host bit layer: NRZI,
flags, unstuffing, CRC, AX.25 parse), from the port's own CUDA-event stage
spans, averaged over the window's decodes."""


def read(ctx):
    vals = [r["stage_seconds"]["framing"] for r in ctx["records"]
            if "framing" in r.get("stage_seconds", {})]
    return sum(vals) / len(vals) if vals else None
