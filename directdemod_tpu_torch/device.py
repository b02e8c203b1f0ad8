"""The port's one device rule.

Every entry point takes `device=None` and resolves it here: None means the
current CUDA device, and raises when there is none (the port is written for
the card; a run on the CPU is asked for, never fallen back to). An explicit
`device="cpu"` runs on the CPU, as the tests do.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: `cuda:<current>` for None (a
    RuntimeError without a CUDA device), else `device` itself, with a bare
    "cuda" given the current index."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present: pass device=\"cpu\" "
                               "to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
