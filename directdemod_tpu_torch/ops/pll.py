"""Carrier and timing recovery of the PSK decoders: the symbol-rate scan (K3).

Port of `directdemod_tpu/ops/pll.py` (`symbol_scan`, `segment_plan`,
`_segments_core`) and of the TPU kernel
`directdemod_tpu/ops/pll_scalar.py::_scan_kernel`. One step handles one
symbol: the mid-symbol B sample and the decision A sample of the filtered
complex stream, each through the AGC (DC tracker, amplitude tracker, gain
cap); Gardner timing from the A, B and previous A samples; the Costas loop
(BPSK or QPSK error through the quantized tanh table, lock hysteresis that
halves the loop bandwidth); and the "minsync" compare of the rolling
hard-decision buffer against the frame sync. For QPSK the minsync result
feeds back (`last_min` gates the buffer push), so the compare is part of
the recurrence.

The step is three recurrences that feed one way: P (timing and AGC), C
(the Costas loop, which needs only P's gained A sample) and M (minsync,
which needs only the sign bits of C's rotated sample). K3 runs them on
three warps that hand symbols over in batches; the plain version runs them
as three passes over a segment (`_stage_p`, `_stage_c`, `_stage_m`), each
updating its own fields of the state rows. No float operation moves.

`symbol_scan` and `symbol_scan_segments` launch K3, the CUDA kernel
`csrc/symbol_scan.cu`, for tensors on a CUDA device and run
`symbol_scan_plain`, Python loops over float32 scalars, for tensors on the
CPU; any other device raises, and there is no fallback from the kernel to
the plain version. Both take the same float32 operations in the same order
as the JAX scan under XLA on the CPU, fused multiply-adds included (XLA
contracts `a * b + c` and turns a division by a constant into a multiply by
its float32 reciprocal); cos and sin are the correctly rounded float32
values of the double-precision functions in both, where XLA uses its own
float32 polynomial, so phases agree with the JAX scan to about 1e-6 rad and
sample indices exactly.

Unlike the JAX scan, which has one output slot per step and a `valid`
mask, both return the valid symbols only, with int64 sample indices (the
reference's float32 (hi, lo) packing holds only 2^27 samples). The minsync
buffers are bit shift registers: entries and sync bits are 0 or 1, so
sum |buf - sync| is popcount(buf XOR sync).
"""
from __future__ import annotations

import ctypes
import logging
import math
from array import array
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..device import resolve

log = logging.getLogger(__name__)

# Number of K3 kernel launches in this process (the plain version does not
# count).
LAUNCHES = 0


@dataclass(frozen=True)
class PskParams:
    """Static configuration for one detector variant."""
    fs: float                    # input sample rate
    sym_rate: float              # symbol rate (12000 funcube, 72000 meteor)
    qpsk: bool                   # costas error form
    agc_mean0: float             # AGC amplitude-tracker init (180 / 3)
    agc_gain_cap: float          # gain cap (20 / 200)
    costas_bw: float             # loop bandwidth (0.05235833333*6 / 0.008727)
    costas_damping: float = 0.70710678118
    minsync_thresh: float = 0.0  # distance trigger (120 / 30)

    @property
    def symbol_period(self) -> float:
        return self.fs / self.sym_rate


def _f32(v: float) -> float:
    return float(np.float32(v))


def alpha_beta(p: PskParams, locked: bool) -> tuple[float, float]:
    """Costas loop gains (alpha, beta) for the lock state, in float64 on the
    host and rounded once to float32 (what the JAX scan does with its weakly
    typed gains)."""
    bw = p.costas_bw / 2.0 if locked else p.costas_bw
    denom = 1.0 + 2.0 * p.costas_damping * bw + bw * bw
    return _f32((4 * p.costas_damping * bw) / denom), _f32((4 * bw * bw) / denom)


# tanh(k) for k = -128..127 as XLA's float32 tanh gives it on the CPU (the
# table the TPU kernel carries). Beyond |k| = 7 it is +-1; six of the eight
# nonzero magnitudes differ from the correctly rounded tanh by an ulp, so
# they are written out here rather than computed.
_TANH_0_7 = (0.0, 0.7615941762924194, 0.9640275835990906, 0.9950547218322754,
             0.9993292093276978, 0.9999091625213623, 0.9999876022338867,
             0.9999983310699463)
TANH_TABLE = tuple(math.copysign(_TANH_0_7[abs(k)] if abs(k) < 8 else 1.0, k)
                   if k else 0.0 for k in range(-128, 128))

# Indices of the step constants (`step_constants`, the kernel's C_*).
(C_T, C_HALF_T, C_T_2E6, C_ALPHA_U, C_BETA_U, C_ALPHA_L, C_BETA_L, C_GAIN_CAP,
 C_INV_255, C_INV_40000, C_TWO_PI, C_LOCK_LO) = range(12)

# State layout: float32 row and int64 row per segment.
(F_TIMING, F_GB_R, F_GB_I, F_GC_R, F_GC_I, F_DC_R, F_DC_I, F_AGC_MEAN,
 F_PHASE, F_FREQ, F_PLL_MEAN) = range(11)
N_FLOAT = 11
(I_STAGE, I_ANCHOR, I_LOCKED, I_CTR, I_LAST_MIN, I_FILL, I_CHOSEN) = range(7)
WORDS = 8                        # 64-bit words of each minsync register
MAX_SYNC_BITS = 64 * WORDS
I_BUF = 7
I_BUF2 = I_BUF + WORDS
N_INT = I_BUF2 + WORDS


class Symbols(NamedTuple):
    """The valid symbols of a scan, in order: the A sample's index (int64),
    the PLL phase in effect during the symbol (float32), whether the minsync
    compare fired there (bool), and the needle choice after it (int8)."""
    a_idx: torch.Tensor
    phase_out: torch.Tensor
    minsync: torch.Tensor
    chosen: torch.Tensor

    @property
    def count(self) -> int:
        return int(self.a_idx.shape[0])


def step_constants(p: PskParams) -> list[float]:
    """The float32 constants of the step, as Python floats, in the order
    of the kernel's C_* indices: T, T/2, T/2e6, alpha and beta unlocked,
    alpha and beta locked, the AGC gain cap, 1/255, 1/40000, 2 pi and the
    lock threshold 0.2."""
    T = p.symbol_period
    al_u, be_u = alpha_beta(p, False)
    al_l, be_l = alpha_beta(p, True)
    return [_f32(T), _f32(T / 2.0), _f32(_f32(T) / 2e6), al_u, be_u, al_l,
            be_l, _f32(p.agc_gain_cap), _f32(1.0 / 255.0), _f32(1.0 / 40000.0),
            _f32(2.0 * np.pi), _f32(0.2)]


def max_symbols(p: PskParams, n: int) -> int:
    """Output room for a scan over n samples: the JAX scan's step count."""
    T = p.symbol_period
    return int(n / T) + 3 + int(n * 4e-6 / T)


def sync_register(bits) -> int:
    """The 0/1 pattern as the shift register it is compared with: entry k
    of `slen` at bit slen-1-k (the newest entry is bit 0)."""
    bits = np.asarray(bits)
    if bits.ndim != 1 or not np.all((bits == 0) | (bits == 1)):
        raise ValueError("sync patterns are 1-D arrays of 0s and 1s")
    if not 0 < len(bits) <= MAX_SYNC_BITS:
        raise ValueError(f"sync length {len(bits)} outside 1..{MAX_SYNC_BITS}")
    slen = len(bits)
    return sum(int(b) << (slen - 1 - k) for k, b in enumerate(bits))


def _to_words(v: int) -> list[int]:
    """Python int register -> WORDS signed int64 words (two's complement)."""
    out = []
    for _ in range(WORDS):
        w = v & 0xFFFFFFFFFFFFFFFF
        out.append(w - (1 << 64) if w >= 1 << 63 else w)
        v >>= 64
    return out


def _from_words(words) -> int:
    return sum((int(w) & 0xFFFFFFFFFFFFFFFF) << (64 * k)
               for k, w in enumerate(words))


def initial_state(p: PskParams, sync_len: int, n_segments: int = 1,
                  device=None) -> dict:
    """The scan state of `n_segments` independent scans (the JAX
    `initial_state` per row): {"f": (S, N_FLOAT) float32, "i": (S, N_INT)
    int64} on `device` (the port's device rule, `device.resolve`)."""
    if not 0 < sync_len <= MAX_SYNC_BITS:
        raise ValueError(f"sync length {sync_len} outside 1..{MAX_SYNC_BITS}")
    device = resolve(device)
    f = torch.zeros(n_segments, N_FLOAT, dtype=torch.float32, device=device)
    f[:, F_AGC_MEAN] = p.agc_mean0
    f[:, F_FREQ] = 0.001
    f[:, F_PLL_MEAN] = 1.0
    i = torch.zeros(n_segments, N_INT, dtype=torch.int64, device=device)
    i[:, I_LAST_MIN] = -1
    return {"f": f, "i": i}


def _check_scan(x: torch.Tensor, state: dict, sync, sync1) -> tuple:
    if x.dtype != torch.complex64 or x.dim() != 1:
        raise ValueError("x must be a 1-D complex64 tensor")
    f, i = state["f"], state["i"]
    if (f.dtype != torch.float32 or i.dtype != torch.int64 or f.dim() != 2
            or f.shape[1] != N_FLOAT or i.shape != (f.shape[0], N_INT)):
        raise ValueError("state must be {'f': (S, 11) float32, 'i': (S, 23) int64}")
    for name, t in (("state['f']", f), ("state['i']", i)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    s0, s1 = sync_register(sync), sync_register(sync1)
    if len(sync) != len(sync1):
        raise ValueError("sync and sync1 differ in length")
    return s0, s1, len(sync)


def _round32():
    """A function rounding a float64 to the nearest float32 (and back)."""
    A = array("f", [0.0])

    def r(v):
        A[0] = v
        return A[0]
    return r


def _stage_p(c: list, xf, n_total: int, start: int, seg_len: int, fs: list,
             is_: list, cap: int, o_a: list) -> tuple[list, bool]:
    """Stage P of one segment (timing and AGC), K3's warp P line for line:
    the B and A sample loads, both AGC updates, Gardner, stage, anchor and
    the step budget. Appends each symbol's A index to `o_a` and updates its
    fields of the state rows in place; returns the gained A sample of each
    symbol, as (re, im) pairs, and whether the budget cut the scan short."""
    r = _round32()
    T, halfT, tk, gcap = c[C_T], c[C_HALF_T], c[C_T_2E6], c[C_GAIN_CAP]
    ceil, sqrt = math.ceil, math.sqrt
    C20, P20, P16 = 1048575.0, 2.0 ** -20, 2.0 ** -16
    timing, gbr, gbi, gcr, gci, dcr, dci, mean = fs[:F_PHASE]
    stage, anchor = is_[I_STAGE], is_[I_ANCHOR]
    ga = []
    cnt = 0
    trunc = False

    def sample(idx):
        g = start + max(idx, 0)
        return (xf[2 * g], xf[2 * g + 1]) if g < n_total else (0.0, 0.0)

    def hypot(a, b):             # XLA's complex abs: max * sqrt(fma(r, r, 1))
        a, b = abs(a), abs(b)
        m, mi = (a, b) if a >= b else (b, a)
        if m == 0.0:
            return 0.0
        q = r(mi / m)
        return r(m * r(sqrt(r(q * q + 1.0))))

    while True:
        if cnt >= cap:           # the step budget: stop where the JAX scan stops
            trunc = anchor + ceil(r(T - timing)) < seg_len
            break
        m_b = ceil(r(halfT - timing))
        m_a = ceil(r(T - timing))
        idx_b = anchor + m_b
        idx_a = anchor + m_a
        at_b = stage == 0
        b_valid = at_b and idx_b < seg_len
        if b_valid:              # B event: AGC the mid-symbol sample
            xr, xi = sample(idx_b)
            dcr = r(r(r(dcr * C20) + xr) * P20)
            dci = r(r(r(dci * C20) + xi) * P20)
            vr, vi = r(xr - dcr), r(xi - dci)
            mean = r(r(mean * 65535.0 + hypot(vr, vi)) * P16)
            g = r(180.0 / mean)
            if g > gcap:
                g = gcap
            gbr, gbi = r(vr * g), r(vi * g)
        if idx_a >= seg_len:     # A beyond the block: it replays next block
            if b_valid or not at_b:
                stage = 1
            break
        # A event: AGC and Gardner; stages C and M take it from here
        xr, xi = sample(idx_a)
        dcr = r(r(r(dcr * C20) + xr) * P20)
        dci = r(r(r(dci * C20) + xi) * P20)
        wr, wi = r(xr - dcr), r(xi - dci)
        mean = r(r(mean * 65535.0 + hypot(wr, wi)) * P16)
        g = r(180.0 / mean)
        if g > gcap:
            g = gcap
        gar, gai = r(wr * g), r(wi * g)
        resync = r(r(gai - gci) * gbi)
        timing = r(r(r(timing + m_a) - T) + resync * tk)
        ga.append((gar, gai))
        o_a.append(start + idx_a)
        cnt += 1
        stage = 0
        anchor = idx_a
        gcr, gci = gar, gai
    fs[:F_PHASE] = [timing, gbr, gbi, gcr, gci, dcr, dci, mean]
    is_[I_STAGE], is_[I_ANCHOR] = stage, anchor
    return ga, trunc


def _stage_c(c: list, qpsk: bool, ga: list, fs: list, is_: list,
             o_ph: list) -> list:
    """Stage C of one segment (the Costas loop), K3's warp C line for line,
    over the gained A samples `ga` of stage P. Appends each symbol's phase
    to `o_ph` and updates its fields of the state rows in place; returns
    each symbol's sign bits (re > 0) << 1 | (im > 0)."""
    r = _round32()
    al_u, be_u, al_l, be_l = c[C_ALPHA_U:C_GAIN_CAP]
    r255, r40k, two_pi, lock_lo = c[C_INV_255:]
    lut = TANH_TABLE
    floor, fmod, cos, sin = math.floor, math.fmod, math.cos, math.sin
    phase, freq, pm = fs[F_PHASE:]
    locked = bool(is_[I_LOCKED])
    bits = []

    def hyp(v):                  # quantized tanh, floor(v + 128) indexing
        if v > 127.0:
            return 1.0
        if v < -128.0:
            return -1.0
        return lut[min(max(floor(r(v + 128.0)), 0), 255)]

    for gar, gai in ga:
        cr = r(cos(phase))
        sr = -r(sin(phase))
        re = r(gar * cr - r(gai * sr))
        im = r(r(gar * sr) + gai * cr)
        if qpsk:
            err = r(r(im * hyp(re) - r(re * hyp(im))) * r255)
        else:
            err = r(r(im * hyp(re)) * r255)
        pm = r(r(pm * 39999.0 + abs(err)) * r40k)
        ec = min(max(err, -1.0), 1.0)
        al, be = (al_l, be_l) if locked else (al_u, be_u)
        raw = r(r(phase + freq) + al * ec)
        o_ph.append(phase)
        phase = (fmod(-raw, two_pi) * -1.0 if raw < 0.0
                 else fmod(raw, two_pi) if raw > 0.0 else 0.0)
        freq = r(freq + be * ec)
        if not locked and pm < lock_lo:
            locked = True
        elif locked and pm > 0.5:
            locked = False
        bits.append((2 if re > 0.0 else 0) | (1 if im > 0.0 else 0))
    fs[F_PHASE:] = [phase, freq, pm]
    is_[I_LOCKED] = int(locked)
    return bits


def _stage_m(qpsk: bool, gate_syms: int, thresh: float, bits: list,
             is_: list, s0: int, s1: int, slen: int, o_min: list,
             o_ch: list) -> None:
    """Stage M of one segment (minsync), K3's warp M line for line, over
    the sign bits of stage C. Appends each symbol's minsync flag and needle
    choice and updates its fields of the state rows in place."""
    mask = (1 << slen) - 1
    half = slen / 2.0
    ctr, last_min, fill, chosen = is_[I_CTR:I_BUF]
    buf = _from_words(is_[I_BUF:I_BUF2])
    buf2 = _from_words(is_[I_BUF2:N_INT])
    for b in bits:
        bre, bim = b >> 1, b & 1
        ctr += 1
        if qpsk:
            gate = last_min < 0 or ctr > last_min + gate_syms
            is_min = False
            if gate:
                buf = ((buf << 2) | (bre << 1) | bim) & mask
                buf2 = ((buf2 << 2) | (bim << 1) | bre) & mask
                fill = min(fill + 2, slen)
                if fill >= slen:
                    if abs((buf ^ s0).bit_count() - half) > thresh:
                        chosen, is_min = 0, True
                    if abs((buf2 ^ s1).bit_count() - half) > thresh:
                        chosen, is_min = 2, True
        else:
            buf = ((buf << 1) | bre) & mask
            fill = min(fill + 1, slen)
            is_min = fill >= slen and abs((buf ^ s0).bit_count() - half) > thresh
        if is_min:
            last_min = ctr
        o_min.append(is_min)
        o_ch.append(chosen)
    is_[I_CTR:] = [ctr, last_min, fill, chosen] + _to_words(buf) + _to_words(buf2)


def _scan_plain(p: PskParams, x: torch.Tensor, state: dict, sync, sync1,
                starts: list, seg_len: int) -> tuple[dict, Symbols, list, list]:
    """K3's contract on the CPU: every segment's scan in turn. Returns what
    `_scan` returns."""
    s0, s1, slen = _check_scan(x, state, sync, sync1)
    c = step_constants(p)
    xf = memoryview(torch.view_as_real(x.contiguous()).reshape(-1).numpy())
    n_total = int(x.shape[0])
    cap = max_symbols(p, seg_len)
    fs_all = state["f"].tolist()
    is_all = state["i"].tolist()
    out = ([], [], [], [])
    counts, trunc = [], []
    for k, start in enumerate(starts):
        fs, is_ = fs_all[k], is_all[k]
        ga, cut = _stage_p(c, xf, n_total, int(start), int(seg_len), fs, is_,
                           cap, out[0])
        bits = _stage_c(c, p.qpsk, ga, fs, is_, out[1])
        _stage_m(p.qpsk, int(0.1 * p.sym_rate), float(p.minsync_thresh), bits,
                 is_, s0, s1, slen, out[2], out[3])
        counts.append(len(ga))
        trunc.append(cut)
    dev = x.device
    new = {"f": torch.tensor(fs_all, dtype=torch.float32, device=dev),
           "i": torch.tensor(is_all, dtype=torch.int64, device=dev)}
    syms = Symbols(torch.tensor(out[0], dtype=torch.int64, device=dev),
                   torch.tensor(out[1], dtype=torch.float32, device=dev),
                   torch.tensor(out[2], dtype=torch.bool, device=dev),
                   torch.tensor(out[3], dtype=torch.int8, device=dev))
    return new, syms, counts, trunc


def symbol_scan_plain(p: PskParams, x: torch.Tensor, state: dict, sync,
                      sync1) -> tuple[dict, Symbols]:
    """K3's contract as a plain Python loop over float32 scalars, one scan
    over all of `x` from `state` (one row): the new state and the valid
    symbols. A sample index is local to `x`."""
    new, syms, _, trunc = _scan_plain(p, x, state, sync, sync1, [0],
                                      int(x.shape[0]))
    _warn_truncated(trunc, max_symbols(p, int(x.shape[0])))
    return new, syms


_libs: dict = {}
# The measurement build of K3: each stage warp sums the SM clocks of its
# work (`stage_cycles`).
STAGE_CLOCK_FLAGS = ("-DK3_STAGE_CLOCKS",)


def _kernel_lib(extra: tuple = ()):
    lib = _libs.get(extra)
    if lib is None:
        lib = _build.load("symbol_scan", extra)
        fn = lib.symbol_scan_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_double,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[extra] = lib
    return lib


def build() -> None:
    """Compile (or find) and load the K3 kernel library."""
    _kernel_lib()


def stage_cycles(p: PskParams, x: torch.Tensor, state: dict, sync, sync1
                 ) -> list[int]:
    """One sequential scan of the CUDA tensor x through K3's measurement
    build: the SM clocks that warps P, C and M spent on their stages' work
    (waits excluded), and P's wall from its first batch to its end. A
    stage's clocks over the symbols is its chain a symbol, alone."""
    lib = _kernel_lib(STAGE_CLOCK_FLAGS)
    _scan(p, x, state, sync, sync1, [0], int(x.shape[0]), lib=lib)
    torch.cuda.synchronize(x.device)
    out = (ctypes.c_ulonglong * 4)()
    err = lib.symbol_scan_stage_cycles(out)
    if err != 0:
        raise RuntimeError(f"symbol_scan_stage_cycles failed: cudaError_t {err}")
    return list(out)


def _scan(p: PskParams, x: torch.Tensor, state: dict, sync, sync1,
          starts: list, seg_len: int, lib=None) -> tuple[dict, Symbols, list, list]:
    """The scan of each segment k over x[starts[k] : starts[k] + seg_len]
    (zero beyond the end of x) from state row k, at most `max_symbols(p,
    seg_len)` steps: K3 on a CUDA device, the plain version on the CPU.
    Returns (new state, the valid symbols of all segments in segment order
    with indices in x's coordinates, the count of each segment, whether the
    step budget stopped each segment with samples left). `lib`: another
    build of K3 (`stage_cycles`)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return _scan_plain(p, x, state, sync, sync1, starts, seg_len)
    if x.device.type != "cuda":
        raise ValueError(f"symbol_scan runs on cuda or cpu, not {x.device}")
    s0, s1, slen = _check_scan(x, state, sync, sync1)
    lib = lib or _kernel_lib()
    dev = x.device
    n_seg = len(starts)
    cap = max_symbols(p, seg_len)
    consts = torch.tensor(step_constants(p), dtype=torch.float32, device=dev)
    lut = torch.tensor(TANH_TABLE, dtype=torch.float32, device=dev)
    words = torch.tensor(_to_words(s0) + _to_words(s1), dtype=torch.int64,
                         device=dev)
    xs = torch.view_as_real(x.contiguous())
    st_f = state["f"].clone()
    st_i = state["i"].clone()
    starts_t = torch.tensor(starts, dtype=torch.int64, device=dev)
    a_idx = torch.empty(n_seg, cap, dtype=torch.int64, device=dev)
    phase = torch.empty(n_seg, cap, dtype=torch.float32, device=dev)
    minsync = torch.empty(n_seg, cap, dtype=torch.bool, device=dev)
    chosen = torch.empty(n_seg, cap, dtype=torch.int8, device=dev)
    counts = torch.empty(n_seg, dtype=torch.int64, device=dev)
    trunc = torch.empty(n_seg, dtype=torch.uint8, device=dev)
    err = lib.symbol_scan_launch(
        xs.data_ptr(), int(x.shape[0]), starts_t.data_ptr(), int(seg_len),
        n_seg, consts.data_ptr(), lut.data_ptr(), words.data_ptr(), slen,
        int(p.qpsk), int(0.1 * p.sym_rate), float(p.minsync_thresh),
        st_f.data_ptr(), st_i.data_ptr(), cap, a_idx.data_ptr(),
        phase.data_ptr(), minsync.data_ptr(), chosen.data_ptr(),
        counts.data_ptr(), trunc.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"symbol_scan kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    keep = torch.arange(cap, device=dev)[None, :] < counts[:, None]
    syms = Symbols(a_idx[keep], phase[keep], minsync[keep], chosen[keep])
    return ({"f": st_f, "i": st_i}, syms, counts.tolist(),
            [bool(t) for t in trunc.tolist()])


def _warn_truncated(trunc: list, cap: int) -> None:
    if any(trunc):
        log.warning("symbol scan: %d of %d segments stopped at the step "
                    "budget of %d symbols with samples left, as the JAX scan "
                    "does (the Gardner timing stepped backwards)",
                    sum(trunc), len(trunc), cap)


def symbol_scan(p: PskParams, x: torch.Tensor, state: dict, sync, sync1
                ) -> tuple[dict, Symbols]:
    """Run the scan over one block of the filtered complex stream from
    `state` (one row): K3 for a CUDA tensor, `symbol_scan_plain` for a CPU
    tensor. `sync` is the 0/1 frame-sync pattern at symbol rate, `sync1`
    the QPSK ambiguity variant (`sync` again for BPSK). A symbol whose A
    sample lies beyond the block leaves the state at it (stage 1 once its B
    sample has been taken), to replay in the next block once the caller has
    rebased the anchor by the block length. Returns the new state and the
    valid symbols, indices local to `x`. Like the JAX scan it takes at most
    `max_symbols` steps; a scan that stops there with samples left is
    logged as a warning."""
    new, syms, _, trunc = _scan(p, x, state, sync, sync1, [0], int(x.shape[0]))
    _warn_truncated(trunc, max_symbols(p, int(x.shape[0])))
    return new, syms


def segment_plan(n: int, n_segments: int, warmup_symbols: int,
                 symbol_period: float, owned_start: int = 0
                 ) -> list[tuple[int, int, int]]:
    """(start, end, scan_from) spans for block-parallel PLL processing.

    Each segment owns an equal slice of [owned_start, n) but starts scanning
    `warmup_symbols` earlier (clamped at 0) so AGC/Costas/Gardner re-lock
    before the owned region. `owned_start` lets a caller prepend warmup
    context from the previous stream block so segment 0 re-locks too.
    """
    per = -(-(n - owned_start) // n_segments)
    warm = int(warmup_symbols * symbol_period)
    plan = []
    for i in range(n_segments):
        s = owned_start + i * per
        e = min(n, s + per)
        plan.append((s, e, max(0, s - warm)))
    return plan


def symbol_scan_segments(p: PskParams, x: torch.Tensor, sync, sync1,
                         n_segments: int, warmup_symbols: int = 2000,
                         owned_start: int = 0, mesh=None
                         ) -> tuple[Symbols, torch.Tensor, torch.Tensor]:
    """Independent scans of overlapping segments of x (the segment-parallel
    mode; exact sequential mode is `symbol_scan`), each from the initial
    state over `seg_len` samples from its `scan_from`, zero beyond the end
    of x (`_segments_core`'s padding). On a card this is one K3 launch, a
    segment on one lane of each of its three stage warps. Returns (the valid symbols of all segments in
    segment order, indices in x's coordinates; the segment of each symbol
    (int64); the `owned` mask, true where the A sample lies in the segment's
    owned span).

    With `mesh` (`parallel.mesh`) the segments are split over its `time`
    shards, which must divide them (a ValueError otherwise, as JAX's
    sharding raises): each shard scans its own consecutive segments in one
    launch on its device, x copied there. A segment's scan does not depend
    on the others, so the result equals the call without a mesh, bit for
    bit."""
    n = int(x.shape[0])
    plan = segment_plan(n, n_segments, warmup_symbols, p.symbol_period,
                        owned_start)
    seg_len = max(e - sf for (_, e, sf) in plan)
    scan_from = [sf for (_, _, sf) in plan]
    dev = x.device
    if mesh is None:
        state = initial_state(p, len(sync), n_segments, dev)
        _, syms, counts, trunc = _scan(p, x, state, sync, sync1, scan_from,
                                       seg_len)
    else:
        from ..parallel.mesh import require_one_process
        require_one_process(mesh, "symbol_scan_segments")
        devs = mesh.time_devices
        if n_segments % len(devs):
            raise ValueError(f"{n_segments} segments are not divisible by the "
                             f"mesh's time axis ({len(devs)})")
        per = n_segments // len(devs)
        parts = [_scan(p, x.to(d), initial_state(p, len(sync), per, d), sync, sync1,
                       scan_from[i * per:(i + 1) * per], seg_len)[1:]
                 for i, d in enumerate(devs)]
        syms = Symbols(*(torch.cat([getattr(sy, f).to(dev) for sy, _, _ in parts])
                         for f in Symbols._fields))
        counts = [c for _, cs, _ in parts for c in cs]
        trunc = [t for _, _, ts in parts for t in ts]
    _warn_truncated(trunc, max_symbols(p, seg_len))
    seg = torch.repeat_interleave(torch.arange(n_segments, device=dev),
                                  torch.tensor(counts, device=dev))
    lo = torch.tensor([s for (s, _, _) in plan], dtype=torch.int64, device=dev)
    hi = torch.tensor([e for (_, e, _) in plan], dtype=torch.int64, device=dev)
    owned = (syms.a_idx >= lo[seg]) & (syms.a_idx < hi[seg])
    return syms, seg, owned
