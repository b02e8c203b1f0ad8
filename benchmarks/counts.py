"""Bytes, operations and least times of the port's kernels, from shapes.

Copies of `chip_smoke.py:1041-1061` (`PEAK_BYTES_S`, `PEAK_FP32_S`, `bound`,
`ddc_bound`) and of K3's count at `chip_smoke.py:894-897`. The peaks are
NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM3 and 67 TFLOP/s of dense
float32 outside the tensor cores, at a 700 W power limit.
"""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12


def least_seconds(n_bytes: float, n_ops: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the fp32 operations over the fp32 peak."""
    return max(n_bytes / PEAK_BYTES_S, n_ops / PEAK_FP32_S)


def ddc_launch(n_in_bytes: int, channels: int, out_len: int, taps: int
               ) -> tuple[int, int]:
    """(bytes, operations) of one K1 or K4 launch: its input read once, the
    audio (4 B an output) and c_last (8 B) written once a channel; 8
    operations a complex tap and ~12 for the discriminator (the atan2
    counted as one) per output and channel."""
    return (n_in_bytes + channels * (4 * out_len + 8),
            channels * out_len * (8 * taps + 12))


def k1_launch_raw(n_samples: int, stride: int, taps: int) -> tuple[int, int]:
    """K1 over `n_samples` samples of raw uint8 IQ (2 B a sample) at
    `stride`, one channel: the outputs are the samples at multiples of the
    stride."""
    out_len = -(-n_samples // stride)
    return ddc_launch(2 * n_samples, 1, out_len, taps)


def k3_symbols(n_symbols: int) -> tuple[int, int]:
    """K3 over `n_symbols` symbols: two complex64 samples read a symbol (B
    and A, 16 B) and 14 B of outputs, so 30 B; about 100 float32 operations
    a step (an estimate: the step's AGC, Gardner, Costas and minsync
    arithmetic, the cos and sin counted as one each)."""
    return 30 * n_symbols, 100 * n_symbols
