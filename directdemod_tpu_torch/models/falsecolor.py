"""False-color APT composite.

Copy of `directdemod_tpu/models/falsecolor.py` (pure NumPy; the JAX
package cannot be imported without importing jax).

Behavioral reference: `decode_noaa.getColor` (ref decode_noaa.py:536-598):
cloud/sea/ground segmentation from the visible (A) and thermal (B) channels,
HSV interpolation between per-class color anchors, colorsys-compatible
HSV->RGB. The reference's per-pixel Python loop becomes one vectorized NumPy
pass (the image is small; no device round-trip is worth it).
"""
from __future__ import annotations

import numpy as np

TEMP_LIMIT = 155.0
SEA_LIMIT = 30.0
LAND_LIMIT = 90.0

# (min_color, max_color) HSV anchors per class (ref decode_noaa.py:573-586)
_CLOUD = (np.array([230 / 360.0, 0.2, 0.3]), np.array([230 / 360.0, 0.0, 1.0]))
_SEA = (np.array([200 / 360.0, 0.7, 0.6]), np.array([240 / 360.0, 0.6, 0.4]))
_GROUND = (np.array([60 / 360.0, 0.6, 0.2]), np.array([100 / 360.0, 0.0, 0.5]))


def _hsv_to_rgb(h, s, v):
    """Vectorized colorsys.hsv_to_rgb (truncating int(h*6) semantics)."""
    i = np.trunc(h * 6.0)
    f = h * 6.0 - i
    i = i.astype(np.int64) % 6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    sz = s == 0.0
    return (np.where(sz, v, r), np.where(sz, v, g), np.where(sz, v, b))


def false_color(image_a: np.ndarray, image_b: np.ndarray) -> np.ndarray:
    """RGB uint8 composite; image_a/image_b are the 1040-px channel images."""
    v = image_a[:, :1040].astype(np.float64)
    t = image_b[:, :1040].astype(np.float64)

    cloud = t < TEMP_LIMIT
    sea = ~cloud & (v < SEA_LIMIT)
    ground = ~cloud & ~sea

    min_c = np.empty(v.shape + (3,))
    max_c = np.empty(v.shape + (3,))
    scale_v = np.empty_like(v)
    scale_t = np.empty_like(v)

    for mask, (mn, mx) in ((cloud, _CLOUD), (sea, _SEA), (ground, _GROUND)):
        min_c[mask] = mn
        max_c[mask] = mx
    scale_v[cloud] = v[cloud] / 256.0
    scale_t[cloud] = (256.0 - t[cloud]) / 256.0
    scale_v[sea] = v[sea] / SEA_LIMIT
    scale_t[sea] = (256.0 - t[sea]) / (256.0 - TEMP_LIMIT)
    scale_v[ground] = (v[ground] - SEA_LIMIT) / (LAND_LIMIT - SEA_LIMIT)
    scale_t[ground] = (256.0 - t[ground]) / (256.0 - TEMP_LIMIT)

    fs = max_c[..., 1] + scale_t * (min_c[..., 1] - max_c[..., 1])
    fv = max_c[..., 2] + scale_v * (min_c[..., 2] - max_c[..., 2])
    fh = max_c[..., 0] + scale_v * scale_t * (min_c[..., 0] - max_c[..., 0])

    r, g, b = _hsv_to_rgb(fh, fs, fv)
    rgb = np.stack([r, g, b], axis=-1) * 255.0
    return np.trunc(rgb).astype(np.int64).astype(np.uint8)
