"""Device choice and per-stage timing shared by the port's decoders."""
from __future__ import annotations

import contextlib
import time

import torch

from ..device import resolve


class TimedDecoder:
    """Base of the decoders: `device` follows the port's device rule
    (`device.resolve`: None is the current CUDA device); `stage_seconds`
    accumulates each stage's time (CUDA events on a card, the host clock on
    the CPU)."""

    def _init_device(self, device) -> None:
        self.device = resolve(device)
        self._timers: list = []

    @contextlib.contextmanager
    def _stage(self, name: str):
        if self.device.type == "cuda":
            t0, t1 = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            t0.record()
            yield
            t1.record()
            self._timers.append((name, t0, t1))
        else:
            t0 = time.perf_counter()
            yield
            self._timers.append((name, t0, time.perf_counter()))

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
