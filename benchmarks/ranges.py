"""The card's idle time and the host's kernel launch calls by program
range, over a trace read by `benchmarks/trace.Events`.

An idle microsecond of the window (no kernel, copy or memset running) goes
to the innermost open range of those named, the shortest, which is the
rule by which `Events.breakdown()` names a gap by a range; launch calls
(CUDA runtime or driver calls whose name holds `LaunchKernel`) are read
from the trace's events, which `Events` does not keep.
"""
from __future__ import annotations

import bisect
import heapq

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def idle_intervals(ev) -> list:
    """The window's idle intervals, (start, end) in microseconds in time
    order; their lengths sum to `ev.window_s - ev.busy_s`."""
    gaps, cur = [], ev.lo
    for s, e in sorted((s, e) for s, e, _, _ in ev.device):
        if e <= ev.lo or s >= ev.hi:
            continue
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if cur < ev.hi:
        gaps.append((cur, ev.hi))
    return gaps


def idle_by_range(ev, names) -> dict:
    """Idle seconds of the window by range: each idle microsecond goes to
    the shortest open range whose name is in `names` (of two as long, the
    name first in order), else to "unranged". {name: seconds}, "unranged"
    always present; the values sum to the window's idle time."""
    names = set(names)
    marks = []
    for i, (s, e, n) in enumerate(ev.stages):
        if n in names and e > s:
            marks += [(s, 1, i), (e, 0, i)]
    marks.sort()
    gaps = idle_intervals(ev)
    out = {"unranged": 0.0}
    open_, heap = set(), []
    gi, prev = 0, ev.lo

    def credit(a, b):
        nonlocal gi
        a, b = max(a, ev.lo), min(b, ev.hi)
        if b <= a:
            return
        while heap and heap[0][2] not in open_:
            heapq.heappop(heap)
        owner = heap[0][1] if heap else "unranged"
        while gi < len(gaps) and gaps[gi][1] <= a:
            gi += 1
        idle, j = 0.0, gi
        while j < len(gaps) and gaps[j][0] < b:
            idle += min(b, gaps[j][1]) - max(a, gaps[j][0])
            j += 1
        if idle > 0.0:
            out[owner] = out.get(owner, 0.0) + idle * 1e-6

    for t, is_start, i in marks:
        credit(prev, t)
        prev = max(prev, t)
        if is_start:
            s, e, n = ev.stages[i]
            open_.add(i)
            heapq.heappush(heap, (e - s, n, i))
        else:
            open_.discard(i)
    credit(prev, ev.hi)
    return out


def launch_times(trace: dict) -> list:
    """The host start, in microseconds and in order, of each kernel launch
    call of a Chrome trace dict."""
    return sorted(float(e["ts"]) for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS
                  and "LaunchKernel" in e.get("name", ""))


def launches_in(ev, launches: list, name: str) -> int:
    """Launch calls (`launch_times`) whose host start falls inside a range
    named `name`, inside the window."""
    got = sorted((max(s, ev.lo), min(e, ev.hi)) for s, e, n in ev.stages if n == name)
    merged: list = []
    for s, e in got:
        if e < s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(bisect.bisect_right(launches, e) - bisect.bisect_left(launches, s)
               for s, e in merged)
