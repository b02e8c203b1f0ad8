"""Output sinks: wav / image / csv.

Copy of `directdemod_tpu/io/sinks.py` (pure NumPy/PIL; the JAX package
cannot be imported without importing jax).

Behavioral reference: `sink.wavFile / image / csv` (ref sink.py:10-108). The
csv writer keeps the reference's zip_longest column layout and trailing-comma
format so downstream consumers see identical files.
"""
from __future__ import annotations

import itertools
import struct

import numpy as np


def write_wav(filename: str, rate: int, samples) -> None:
    """Minimal RIFF writer equivalent to scipy.io.wavfile.write for the dtypes
    the decoders produce (float32/float64 -> IEEE float, int16 -> PCM). A
    tensor is taken to the host first."""
    a = np.asarray(samples.cpu() if hasattr(samples, "cpu") else samples)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    if a.dtype == np.float32:
        fmt_tag, bits = 3, 32
    elif a.dtype == np.int16:
        fmt_tag, bits = 1, 16
    else:
        a = a.astype(np.float32)
        fmt_tag, bits = 3, 32
    nch = 1 if a.ndim == 1 else a.shape[1]
    payload = a.tobytes()
    byte_rate = rate * nch * bits // 8
    block_align = nch * bits // 8
    with open(filename, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(payload)))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_tag, nch, int(rate),
                            byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(payload)))
        f.write(payload)


def write_image(filename: str, matrix: np.ndarray) -> None:
    """PNG/etc. via PIL (ref sink.py:57-64)."""
    from PIL import Image
    Image.fromarray(np.asarray(matrix)).save(filename)


def show_image(matrix: np.ndarray) -> None:
    """Open the image in PIL's viewer (ref sink.py:57-64)."""
    from PIL import Image
    Image.fromarray(np.asarray(matrix)).show()


def write_csv(filename: str, columns, titles=None) -> None:
    """Column-wise csv with zip_longest padding (ref sink.py:98-108)."""
    with open(filename, "w") as f:
        if titles is not None:
            print("".join(str(t) + "," for t in titles), file=f)
        for row in itertools.zip_longest(*columns, fillvalue=""):
            print("".join(str(v) + "," for v in row), file=f)
