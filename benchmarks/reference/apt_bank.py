"""Plain reference of the NOAA APT decode of several channels of one
capture: each channel by itself, from the capture's bytes.

For each channel of `cfg["channels"]` the single-channel plain chain of
`benchmarks/reference/apt.py` (`front`, then `products`) runs over the same
bytes at that channel's offset, in fp64 (its control in float32 with TF32
convolutions). The channels share nothing: no bank, no batch. It imports
nothing of the port and takes nothing the port made, and it runs with
PyTorch's TF32 switches off (`reference.apt`'s control rounds to TF32 by
hand).
"""
from __future__ import annotations

import contextlib

import torch

from benchmarks.reference import apt


@contextlib.contextmanager
def _tf32_off():
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def channel_cfg(cfg: dict, c: int) -> dict:
    """The single-channel configuration of channel `c`: `cfg` at its
    offset."""
    return {**cfg, "offset_hz": float(cfg["channels"][c]["offset_hz"])}


def front(raw: torch.Tensor, cfg: dict, c: int, precision: str = "fp64") -> dict:
    """`reference.apt.front` of channel `c`."""
    with _tf32_off():
        return apt.front(raw, channel_cfg(cfg, c), precision)


def products(raw: torch.Tensor, cfg: dict, c: int, fr: dict, sync_a, sync_b) -> dict:
    """`reference.apt.products` of channel `c` from its front end `fr`."""
    with _tf32_off():
        return apt.products(raw, channel_cfg(cfg, c), fr, sync_a, sync_b)


def decode(raw: torch.Tensor, cfg: dict, c: int, precision: str = "fp64") -> dict:
    """The whole reference decode of channel `c` (`reference.apt.decode`)."""
    with _tf32_off():
        return apt.decode(raw, channel_cfg(cfg, c), precision)
