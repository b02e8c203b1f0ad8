"""Raw interleaved uint8 IQ -> complex baseband.

Port of `directdemod_tpu/ops/unpack.py`: the source byte contract
``(I + jQ) - (127.5 + 127.5j)`` over interleaved uint8 pairs. A pair view of
the bytes makes the deinterleave free: `view_as_complex` reads the
(..., N, 2) float pairs as (..., N) complex in place.
"""
from __future__ import annotations

import torch

IQ_U8_OFFSET = 127.5


def iq_u8_to_complex(raw: torch.Tensor, dtype=torch.complex64) -> torch.Tensor:
    """(..., 2N) interleaved uint8 -> (..., N) complex64 (or `dtype`),
    minus 127.5."""
    pairs = raw.reshape(raw.shape[:-1] + (raw.shape[-1] // 2, 2))
    real = torch.float64 if dtype == torch.complex128 else torch.float32
    return torch.view_as_complex(pairs.to(real) - IQ_U8_OFFSET)

