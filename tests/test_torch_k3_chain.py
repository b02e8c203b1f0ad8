"""Stage C of K3 (`directdemod_tpu_torch/csrc/symbol_scan.cu`) on the CPU:
a Python model of its cos and sin and of its phase wrap, held to the
functions they stand in for.

C takes cos and sin of a float32 phase as the float32 roundings of the
double functions. For |x| <= 8 it evaluates a short reduction and musl's
polynomials in double and keeps their float32 roundings where the 29
mantissa bits that rounding discards lie farther than SINCOS_MARGIN ulps
from the midpoint (and the result is a normal float32); elsewhere the full
sincos runs. The model evaluates the same double operations in the same
order, each fused multiply-add exactly (through `fractions.Fraction`, as
Python 3.12 has no `math.fma`), and the test holds every phase the guard
passes to float32(math.cos / math.sin). The wrap of |raw| in [2 pi, 4 pi)
is |raw| - 2 pi: equal to fmodf there by Sterbenz's lemma, checked on every
float32 of the range."""
import math
import struct
from fractions import Fraction

import numpy as np
import pytest

# the kernel's constants (csrc/symbol_scan.cu, cos_sin_short)
TWO_OVER_PI = 0.63661977236758134308
PIO2_HI = 1.57079632679489655800e+00
PIO2_LO = 6.12323399573676603587e-17
S1, S2, S3, S4, S5 = (-1.66666666666666324348e-01, 8.33333333332248946124e-03,
                      -1.98412698298579493134e-04, 2.75573137070700676789e-06,
                      -2.50507602534068634195e-08)
S6 = 1.58969099521155010221e-10
C1, C2, C3 = 4.16666666666666019037e-02, -1.38888888888741095749e-03, 2.48015872894767294178e-05
C4, C5, C6 = -2.75573143513906633035e-07, 2.08757232129817482790e-09, -1.13596475577881948265e-11
SINCOS_MARGIN = 128


def fma(a: float, b: float, c: float) -> float:
    """a * b + c rounded once to double."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def f32(v: float) -> float:
    return float(np.float32(v))


def rounds_clear(d: float) -> bool:
    """The kernel's guard: d's float32 rounding is settled (d is a normal
    float32 magnitude, and its 29 discarded bits lie farther than the
    margin from the midpoint)."""
    bits = struct.unpack("<Q", struct.pack("<d", d))[0]
    lo = bits & 0x1FFFFFFF
    ex = (bits >> 32) & 0x7FF00000
    return ex >= 0x38100000 and abs(lo - (1 << 28)) > SINCOS_MARGIN


def cos_sin_short(x: float):
    """C's short path for the float32 phase x: (cos, sin, whether the guard
    passes), in the kernel's order of double operations."""
    xd = float(x)
    k = float(round(xd * TWO_OVER_PI))          # rint: round half to even
    r = fma(-k, PIO2_HI, xd)
    r = fma(-k, PIO2_LO, r)
    z = r * r
    w = z * z
    rs = fma(z, fma(z, S4, S3), S2) + z * w * fma(z, S6, S5)
    sr = fma(z * r, fma(z, rs, S1), r)
    rc = z * fma(z, fma(z, C3, C2), C1) + w * w * fma(z, fma(z, C6, C5), C4)
    hz = 0.5 * z
    h = 1.0 - hz
    cr = h + (((1.0 - h) - hz) + z * rc)
    q = int(k) & 3
    fs, fc = f32(sr), f32(cr)
    s1, c1 = (fc, fs) if q & 1 else (fs, fc)
    s = -s1 if q & 2 else s1
    c = -c1 if (q + 1) & 2 else c1
    return c, s, abs(xd) <= 8.0 and rounds_clear(sr) and rounds_clear(cr)


def _midpoint_distance(v: np.ndarray) -> np.ndarray:
    """Ulps of v (float64) from the nearest float32 rounding midpoint."""
    lo = v.view(np.uint64) & np.uint64(0x1FFFFFFF)
    return np.abs(lo.astype(np.int64) - (1 << 28))


def _phases(seed: int) -> np.ndarray:
    """~20,000 float32 phases in (-2 pi, 2 pi): uniform ones, the floats
    within 32 ulps of each k pi / 2, and the candidates of 400,000 whose
    double cos or sin lies nearest a float32 rounding midpoint."""
    rng = np.random.default_rng(seed)
    two_pi = 2 * np.pi
    uniform = rng.uniform(-two_pi, two_pi, 12_000).astype(np.float32)
    tiny = np.arange(0, 33, dtype=np.int32).view(np.float32)   # 0 and subnormals
    near_axes = [tiny, -tiny[1:]]
    for k in range(1, 5):
        bits = np.float32(k * np.pi / 2).view(np.int32) + np.arange(-32, 33, dtype=np.int32)
        near_axes += [bits.view(np.float32), -bits.view(np.float32)]
    cand = rng.uniform(-two_pi, two_pi, 400_000).astype(np.float32)
    xd = cand.astype(np.float64)
    dist = np.minimum(_midpoint_distance(np.cos(xd)), _midpoint_distance(np.sin(xd)))
    near_mid = cand[np.argsort(dist)[:7_000]]
    return np.concatenate([uniform, *near_axes, near_mid])


@pytest.mark.parametrize("seed", [19, 20])
def test_guard_passes_only_where_the_short_form_rounds_as_libm(seed):
    xs = _phases(seed)
    passed = 0
    for x in xs.tolist():
        c, s, ok = cos_sin_short(x)
        if not ok:
            continue
        passed += 1
        assert c == f32(math.cos(x)), x
        assert s == f32(math.sin(x)), x
    # the guard falls back at 0 and the 64 subnormals (sin below float32's
    # normal range) and rarely elsewhere, even on phases picked near midpoints
    assert len(xs) - passed <= 65 + 10


def test_guard_rejects_near_midpoints_and_small_results():
    """The bit test itself: a double exactly on a float32 rounding
    midpoint, and within the margin of it, fails; past the margin passes;
    results below float32's normal range fail."""
    one_third = f32(1.0 / 3.0)
    mid_bits = struct.unpack("<Q", struct.pack("<d", one_third))[0] | (1 << 28)
    for off, ok in ((0, False), (SINCOS_MARGIN, False), (-SINCOS_MARGIN, False),
                    (SINCOS_MARGIN + 1, True), (-SINCOS_MARGIN - 1, True)):
        d = struct.unpack("<d", struct.pack("<Q", mid_bits + off))[0]
        assert rounds_clear(d) is ok
    assert not rounds_clear(2.0 ** -127) and rounds_clear(2.0 ** -125)
    assert not cos_sin_short(0.0)[2]          # sin(0) = 0: the full sincos runs
    assert not cos_sin_short(8.5)[2]          # beyond the short reduction


def test_wrap_is_one_subtraction_below_four_pi():
    """fmodf(ar, 2 pi_f) == ar - 2 pi_f for every float32 ar in
    [2 pi_f, 4 pi_f) (the subtraction is exact: Sterbenz), and the two
    differ at 4 pi_f, where the kernel takes fmodf."""
    two_pi = np.float32(2.0 * np.pi)
    lo = two_pi.view(np.int32)
    hi = (two_pi * np.float32(2)).view(np.int32)
    ar = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    assert ar.shape[0] == 2 ** 23
    np.testing.assert_array_equal(np.fmod(ar, two_pi), ar - two_pi)
    four_pi = two_pi * np.float32(2)
    assert np.fmod(four_pi, two_pi) != four_pi - two_pi
