"""The device trace of a window: `torch.profiler` with CPU and CUDA activity,
read back from its Chrome trace into device intervals and host operations.

Device time is every kernel, copy and memset on the card's timeline; the
window is the span from the first decode's start to the last decode's end
(the harness marks each decode with a `bench.decode` range).
"""
from __future__ import annotations

import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length, in seconds, of the union of (start, end) microsecond
    intervals clipped to [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


class Events:
    """Device intervals, host operations and decode spans of one trace."""

    def __init__(self, trace: dict):
        dev, host, spans, stages = [], [], [], []
        for ev in trace.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev["dur"])
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                dev.append((s, e, ev.get("name", "?"), cat))
            elif cat == "user_annotation":
                if ev.get("name") == "bench.decode":
                    spans.append((s, e))
                else:
                    stages.append((s, e, ev.get("name", "?")))
            elif cat == "cpu_op":
                host.append((s, e, ev.get("name", "?")))
        self.device = dev
        self.host = host
        self.stages = stages
        self.spans = sorted(spans)
        if self.spans:
            self.lo, self.hi = self.spans[0][0], max(e for _, e in self.spans)
        else:
            self.lo = self.hi = 0.0
        self.window_s = (self.hi - self.lo) * 1e-6
        self.busy_s = union_seconds([(s, e) for s, e, _, _ in dev], self.lo, self.hi)

    def kernel_seconds(self, substring: str) -> tuple[float, int]:
        """Summed device seconds and count of the kernels whose name holds
        `substring`, inside the window."""
        sel = [(s, e) for s, e, n, c in self.device
               if c == "kernel" and substring in n and s >= self.lo and e <= self.hi]
        return sum(e - s for s, e in sel) * 1e-6, len(sel)

    def copy_seconds(self, kind: str) -> float:
        """Summed device seconds of the copies whose name holds `kind`
        ("HtoD", "DtoH", "DtoD"), inside the window."""
        return sum(e - s for s, e, n, c in self.device
                   if c == "gpu_memcpy" and kind in n
                   and s >= self.lo and e <= self.hi) * 1e-6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the innermost host operation running at each gap's
        middle, else by the innermost range marked there ("<range> host
        Python"), else "host Python"."""
        by_name: dict = {}
        for s, e, n, _ in self.device:
            if s >= self.lo and e <= self.hi:
                by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, cur = [], self.lo
        for s, e in sorted((s, e) for s, e, _, _ in self.device):
            if e <= self.lo or s >= self.hi:
                continue
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < self.hi:
            gaps.append((cur, self.hi))
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in gaps:
            mid = 0.5 * (a + b)
            inner = [(e - s, n) for s, e, n in self.host if s <= mid <= e]
            stage = [(e - s, n) for s, e, n in self.stages if s <= mid <= e]
            name = (min(inner)[1] if inner else
                    min(stage)[1] + " host Python" if stage else "host Python")
            named.append([name, (b - a) * 1e-6])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


class Tracer:
    """`torch.profiler` over the window; `stop()` returns its `Events`.
    The drivers mark the program's public calls as ranges of the trace
    (`noaa.get_image`, `funcube.get_syncs`), which name the idle gaps that
    fall inside them."""

    def __init__(self, workdir: str, on_card: bool):
        self.workdir = workdir
        self.on_card = on_card
        self.prof = None

    def start(self) -> None:
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def span(self, name: str):
        import torch
        return torch.profiler.record_function(name)

    def stop(self):
        import torch
        if self.on_card:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        path = os.path.join(self.workdir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
        os.remove(path)
        self.prof = None
        return Events(trace)
