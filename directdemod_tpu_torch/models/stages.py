"""Device choice, per-stage timing, spans and counters shared by the port's
decoders.

Spans: each stage of a decoder is a range `<layer>.<stage>` (`noaa`,
`psk`, `afsk`, `fm`), and a stage may open child ranges
`<layer>.<stage>.<child>`, in the trace of a `torch.profiler` session
(`utils.profiling.trace(logdir)` writes one). Kineto stamps them on the
timeline of the card's kernels and copies, so an idle stretch of the card
can be put down to the host work that held it. With no profiler recording
a span costs a flag check.

Counters: `TimedDecoder.counters` sums the work a decoder did (candidates
copied, correlations run), always. While a profiler records, each count is
also added to the session's tally (`session_counts()`), which restarts
with each session. Code below the decoders (`ops/iir`'s block constants)
adds to the tally alone through `count()`.

Python's garbage collector: while a profiler records, each collection is
the range `host.gc`, a child of whatever range is open. The hook goes into
`gc.callbacks` at the first span, stage, count or tally read that finds a
profiler recording, and comes out at the first that finds none; with no
profiler it is never there, and one left in after a session opens no range.

`span_names()` names the ranges the program opened in the session, so a
reader of the trace tells them from ranges opened around the program.
"""
from __future__ import annotations

import contextlib
import gc
import time

import torch

from ..device import resolve

# the tally of the process's profiler session (`session_counts`), the
# names of the ranges the program opened in it (`span_names`) and the range
# of the collection in progress (`_gc_hook`)
_session = {"recording": False, "counts": {}, "names": set(), "gc": None}


def _recording() -> bool:
    """Whether a profiler records in this process now (`torch.profiler`,
    `utils.profiling.trace`, `torch.autograd.profiler.emit_nvtx`). A call
    that finds a session starting restarts the tally and the names and
    puts the GC hook in; one that finds it ended takes the hook out."""
    on = bool(torch.autograd.profiler._is_profiler_enabled)
    if on != _session["recording"]:
        if on:
            _session["counts"] = {}
            _session["names"] = set()
            if _gc_hook not in gc.callbacks:
                gc.callbacks.append(_gc_hook)
        elif _gc_hook in gc.callbacks:
            gc.callbacks.remove(_gc_hook)
        _session["recording"] = on
    return on


def _gc_hook(phase: str, info: dict) -> None:
    """A `gc.callbacks` entry: the collection as the range `host.gc`,
    opened at its "start" and closed at its "stop", while a profiler
    records."""
    if phase == "start":
        # `_recording` only while one records: it then leaves
        # `gc.callbacks`, which the collector is walking, as it is
        if torch.autograd.profiler._is_profiler_enabled and _recording():
            _session["names"].add("host.gc")
            rf = torch.profiler.record_function("host.gc")
            rf.__enter__()
            _session["gc"] = rf
        return
    rf, _session["gc"] = _session["gc"], None
    if rf is not None:
        rf.__exit__(None, None, None)


def session_counts() -> dict:
    """The counts added while the current profiler session records, or
    the last session's once it has stopped: {counter name: total}. The
    tally restarts at the first span, stage, count or call of this function
    that finds a profiler recording after one that found none, so a session
    in which none of them runs leaves the last session's tally."""
    _recording()
    return dict(_session["counts"])


@contextlib.contextmanager
def span(name: str):
    """A `torch.profiler.record_function` range named `name` while a
    profiler records; nothing otherwise."""
    if not _recording():
        yield
        return
    _session["names"].add(name)
    with torch.profiler.record_function(name):
        yield


def span_names() -> set:
    """The names of the ranges the program opened (`span`, `host.gc`)
    while the current profiler session records, or the last session's once
    it has stopped; restarted with the tally (`session_counts`)."""
    _recording()
    return set(_session["names"])


def count(name: str, n: int) -> None:
    """Add `n` to the profiler session's tally under `name` while a
    profiler records; nothing otherwise."""
    if _recording():
        tally = _session["counts"]
        tally[name] = tally.get(name, 0) + n


class TimedDecoder:
    """Base of the decoders: `device` follows the port's device rule
    (`device.resolve`: None is the current CUDA device); `stage_seconds`
    accumulates each stage's time (CUDA events on a card, the host clock on
    the CPU), `counters` the work counted at the stages' boundaries under
    `<layer>.<stage>.<counter>`. A subclass names its `layer`."""

    layer: str

    def _init_device(self, device) -> None:
        self.device = resolve(device)
        self._timers: list = []
        self.counters: dict = {}

    @contextlib.contextmanager
    def _stage(self, name: str):
        """Time the body as stage `name` and mark it as the range
        `<layer>.<name>`; the time is kept when the body raises."""
        cuda = self.device.type == "cuda"
        if cuda:
            t0, t1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            t0 = time.perf_counter()
        try:
            with span(f"{self.layer}.{name}"):
                yield
        finally:
            if cuda:
                t1.record()
                self._timers.append((name, t0, t1))
            else:
                self._timers.append((name, t0, time.perf_counter()))

    def _span(self, name: str):
        """The child range `<layer>.<name>`, `name` being
        `<stage>.<child>`: no timing, no synchronise."""
        return span(f"{self.layer}.{name}")

    def _count(self, name: str, n: int) -> None:
        """Add `n` to the counter `<layer>.<name>`, and to the profiler
        session's tally while one records."""
        key = f"{self.layer}.{name}"
        self.counters[key] = self.counters.get(key, 0) + n
        count(key, n)

    @property
    def stage_seconds(self) -> dict:
        out: dict = {}
        for name, a, b in self._timers:
            if isinstance(a, float):
                dt = b - a
            else:
                b.synchronize()
                dt = a.elapsed_time(b) / 1e3
            out[name] = out.get(name, 0.0) + dt
        return out
