"""FM demodulation: the polar discriminator.

Port of `directdemod_tpu/ops/fm.py:18` (`demod_fm.demod`):
``angle(s[n] * conj(s[n-1]))`` with the previous block's last sample carried
so that chunked == unchunked.
"""
from __future__ import annotations

import torch


def quad_demod(x: torch.Tensor, last: torch.Tensor | None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Polar discriminator over the last axis. `last` is the previous
    block's final sample, or None on the first block (the output is then one
    sample shorter). Returns (audio, new_last)."""
    prod = x[..., 1:] * x[..., :-1].conj()
    if last is not None:
        prod = torch.cat([(x[..., :1] * last.conj()), prod], dim=-1)
    return torch.angle(prod), x[..., -1:]
