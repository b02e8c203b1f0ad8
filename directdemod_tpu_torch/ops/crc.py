"""AX.25 frame check sequence (CRC-16/X.25, LSB-first).

Copy of `directdemod_tpu/ops/crc.py` (host NumPy; the JAX package cannot be
imported without importing jax). Poly 0x8408 (reflected 0x1021), init
0xffff, final xor 0xffff, the result rendered LSB-first as a bit string.
Frames are a few thousand bits, so a table-driven host implementation is
plenty. `fcs_crc16_check` is the decoder's form: the verdict of many
byte-aligned segments in one pass of the same table.
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


def fcs_crc16_check(data: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """FCS verdicts of many segments at once. `data` holds the segments'
    bytes back to back (uint8, each byte's bits LSB-first on the wire, as
    `np.packbits(..., bitorder="little")` packs them), `counts` each
    segment's byte count; a segment's last two bytes are its FCS, low byte
    first. Returns, for each segment, whether the CRC of the bytes before
    the FCS equals it: `fcs_crc16_bits(bits[:-16]) == bits[-16:]` over the
    segment's bits, False for a segment under two bytes. The table
    recurrence runs a byte column at a time over every segment still that
    long (longest first), so its Python loop is as long as the longest
    segment, not the total."""
    data = np.asarray(data, dtype=np.uint8)
    counts = np.asarray(counts, dtype=np.int64)
    ends = np.cumsum(counts)
    body = counts - 2
    order = np.argsort(-body, kind="stable")
    first = (ends - counts)[order]
    left = body[order]
    reg = np.full(len(counts), 0xFFFF, dtype=np.int64)
    table = _TABLE.astype(np.int64)
    k = len(left)
    for col in range(int(left[0]) if k else 0):
        while left[k - 1] <= col:
            k -= 1
        r = reg[:k]
        reg[:k] = (r >> 8) ^ table[(r ^ data[first[:k] + col]) & 0xFF]
    crc = np.empty_like(reg)
    crc[order] = reg ^ 0xFFFF
    ok = counts >= 2
    if not ok.any():
        return ok
    last = np.where(ok, ends - 1, 1)
    sent = data[last - 1].astype(np.int64) | (data[last].astype(np.int64) << 8)
    return ok & (crc == sent)
