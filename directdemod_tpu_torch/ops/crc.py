"""AX.25 frame check sequence (CRC-16/X.25, LSB-first).

Copy of `directdemod_tpu/ops/crc.py` (host NumPy; the JAX package cannot be
imported without importing jax). Poly 0x8408 (reflected 0x1021), init
0xffff, final xor 0xffff, the result rendered LSB-first as a bit string.
Frames are a few thousand bits, so a table-driven host implementation is
plenty.
"""
from __future__ import annotations

import numpy as np

_POLY = 0x8408


def _build_table() -> np.ndarray:
    tbl = np.empty(256, dtype=np.uint16)
    for byte in range(256):
        fcs = byte
        for _ in range(8):
            fcs = (fcs >> 1) ^ _POLY if fcs & 1 else fcs >> 1
        tbl[byte] = fcs
    return tbl


_TABLE = _build_table()


def fcs_crc16_bits(bits) -> str:
    """CRC over a bit sequence (ints or '0'/'1' chars), returned as the
    reference's LSB-first 16-char bit string."""
    arr = np.asarray([int(b) for b in bits], dtype=np.uint8)
    fcs = 0xFFFF
    n8 = (len(arr) // 8) * 8
    if n8:
        # bits are LSB-first on the wire: pack each 8 into a byte
        bytes_ = np.packbits(arr[:n8].reshape(-1, 8), axis=-1, bitorder="little").ravel()
        for b in bytes_:
            fcs = (fcs >> 8) ^ int(_TABLE[(fcs ^ int(b)) & 0xFF])
    for bit in arr[n8:]:
        shift = fcs & 1
        fcs >>= 1
        if shift != int(bit):
            fcs ^= _POLY
    fcs ^= 0xFFFF
    return format(fcs, "016b")[::-1]
