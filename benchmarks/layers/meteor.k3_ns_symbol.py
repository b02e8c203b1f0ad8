"""Kernel K3 (`ops/pll.py`, `csrc/symbol_scan.cu`) on the QPSK scan: its
device time a symbol, in ns. The device time is every `symbol_scan_kernel`
in the traced window; the symbols are the program's counter
`psk.symbol_scan.symbols`, the profiler session's tally over the same
window (`models.stages.session_counts`). K3 is a dependent chain, whose
bytes-roofline share says nothing; its time a symbol is what shortening
the chain moves. None when the trace holds no such kernel or the program
keeps no such counter."""

KERNEL = "symbol_scan_kernel"
COUNTER = "psk.symbol_scan.symbols"


def read(ctx):
    ev = ctx["events"]
    if ev is None:
        return None
    from directdemod_tpu_torch.models import stages
    tally = getattr(stages, "session_counts", dict)()
    t, n = ev.kernel_seconds(KERNEL)
    if n == 0 or t <= 0.0 or tally.get(COUNTER, 0) <= 0:
        return None
    return 1e9 * t / tally[COUNTER]
