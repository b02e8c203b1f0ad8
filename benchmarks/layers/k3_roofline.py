"""Kernel K3 (`ops/pll.py`, `csrc/symbol_scan.cu`): its least time over
its device time in the traced window, in per cent. The least time counts
30 B and about 100 fp32 operations a symbol (`benchmarks/counts.py`; the
operation count is an estimate) for the symbols each decode's scans
returned; the device time is every `symbol_scan_kernel` in the trace. K3
is a dependent chain, so the share is tiny; it still tracks K3's time."""

KERNEL = "symbol_scan_kernel"


def read(ctx):
    ev = ctx["events"]
    if ev is None:
        return None
    t, n = ev.kernel_seconds(KERNEL)
    least = sum(r.get("least_s", {}).get(KERNEL, 0.0) for r in ctx["records"])
    if n == 0 or t <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / t
