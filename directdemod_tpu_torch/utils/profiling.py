"""Per-stage throughput counters and the profiler hook.

Port of `directdemod_tpu/utils/profiling.py:20-76`: every stage can record
(samples, seconds) and report Msamples/s, with the JAX module's key names
and rounding. `trace()` wraps a region in `torch.profiler` (the CPU, and
the card when one is present) where the JAX module wraps it in the JAX
profiler, and writes a Chrome trace into `logdir` on exit (TensorBoard's
PyTorch profiler plugin or chrome://tracing read it).

Stage seconds are the host clock around the region, as in the JAX module:
on a card, work the region launched may still be running when it ends.
"""
from __future__ import annotations

import contextlib
import logging
import time
from collections import defaultdict
from dataclasses import dataclass

import torch

log = logging.getLogger(__name__)


@dataclass
class StageStats:
    samples: int = 0
    seconds: float = 0.0
    calls: int = 0

    @property
    def msamples_per_s(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0


class Profiler:
    """Accumulates per-stage samples/s. Thread-unsafe by design (one stream)."""

    def __init__(self):
        self.stages: dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str, samples: int):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            st = self.stages[name]
            st.samples += samples
            st.seconds += dt
            st.calls += 1

    def report(self) -> dict:
        return {name: {"msamples_per_s": round(s.msamples_per_s, 2),
                       "samples": s.samples, "seconds": round(s.seconds, 4),
                       "calls": s.calls}
                for name, s in self.stages.items()}

    def log_report(self) -> None:
        for name, r in self.report().items():
            log.info("stage %-20s %10.1f Msamp/s  (%d samples, %d calls)",
                     name, r["msamples_per_s"], r["samples"], r["calls"])


@contextlib.contextmanager
def trace(logdir: str):
    """`torch.profiler` trace of a region, CPU activity plus CUDA activity
    when a card is present; on exit a Chrome trace (a `*.pt.trace.json`
    file named by host, process and time) is written into `logdir`. Yields
    the profile (`key_averages()` and the like)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof


@contextlib.contextmanager
def wall_clock(label: str = "run"):
    t0 = time.perf_counter()
    yield
    log.info("%s took %.3f s", label, time.perf_counter() - t0)
