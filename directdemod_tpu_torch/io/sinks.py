"""Output sinks: image / csv.

Copy of the image and csv writers of `directdemod_tpu/io/sinks.py` (pure
NumPy/PIL; the JAX package cannot be imported without importing jax).

Behavioral reference: `sink.image / csv` (ref sink.py:57-108). The
csv writer keeps the reference's zip_longest column layout and trailing-comma
format so downstream consumers see identical files.
"""
from __future__ import annotations

import itertools

import numpy as np


def write_image(filename: str, matrix: np.ndarray) -> None:
    """PNG/etc. via PIL (ref sink.py:57-64)."""
    from PIL import Image
    Image.fromarray(np.asarray(matrix)).save(filename)


def write_csv(filename: str, columns, titles=None) -> None:
    """Column-wise csv with zip_longest padding (ref sink.py:98-108)."""
    with open(filename, "w") as f:
        if titles is not None:
            print("".join(str(t) + "," for t in titles), file=f)
        for row in itertools.zip_longest(*columns, fillvalue=""):
            print("".join(str(v) + "," for v in row), file=f)
