"""Kernel K1 (`ops/ddc.py`, `csrc/ddc_fm_u8.cu`) on the bank's path, three
channels in one launch: its least time over its device time in the traced
window, in per cent. The least time of each decode's launch comes from its
shape (`benchmarks/counts.ddc_launch` with the channel count: the bytes read
once and every channel's audio written once, over 3.35 TB/s, against the
fp32 operations of every channel over 67 TFLOP/s, H100 SXM data sheet at
700 W); the device time is every `ddc_fm_u8_kernel` in the trace."""

KERNEL = "ddc_fm_u8_kernel"


def read(ctx):
    ev = ctx["events"]
    if ev is None:
        return None
    t, n = ev.kernel_seconds(KERNEL)
    least = sum(r.get("least_s", {}).get(KERNEL, 0.0) for r in ctx["records"])
    if n == 0 or t <= 0.0 or least <= 0.0:
        return None
    return 100.0 * least / t
