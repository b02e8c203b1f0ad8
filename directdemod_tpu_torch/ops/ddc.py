"""K1: the fused byte-domain DDC + FM front end step.

Port of `directdemod_tpu/ops/pallas_ddc.py::ddc_fm_pallas_u8` (the Pallas
kernel `_kernel_u8`) and of its XLA lowering
`directdemod_tpu/ops/ddc_conv.py::BytePlan.apply_dot`: from raw interleaved
uint8 IQ bytes, output m is

    c[m]     = sum_n w[n] (x[m*J + n]),  x[s] = raw[2s] - 127.5 + 1j (raw[2s+1] - 127.5)
    audio[m] = angle(c[m] * conj(c[m-1]) * rot),  c[-1] = c_prev

with `w` the reversed NCO-modulated taps, so output m reads bytes
raw[2*m*J .. 2*(m*J+K)). Returns (audio float32 (out_len,), c_last
complex64 (1,)), c_last being c[out_len - 1], the carry of the next block.

`ddc_fm_u8` launches the CUDA kernel `csrc/ddc_fm_u8.cu` for tensors on a
CUDA device and runs `ddc_fm_u8_plain` for tensors on the CPU; any other
device raises. There is no fallback from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Number of kernel launches in this process (the plain version does not count).
LAUNCHES = 0

_PLAIN_CHUNK = 1 << 16      # outputs per window matrix in the plain version


def _check(raw: torch.Tensor, taps_rev: torch.Tensor, rot: torch.Tensor,
           c_prev: torch.Tensor, stride: int, out_len: int) -> int:
    """Validate the kernel's argument contract; returns K."""
    if raw.dtype != torch.uint8 or raw.dim() != 1 or not raw.is_contiguous():
        raise ValueError("raw must be a contiguous 1-D uint8 tensor")
    for name, t in (("taps_rev", taps_rev), ("rot", rot), ("c_prev", c_prev)):
        if t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous complex64 tensor")
        if t.device != raw.device:
            raise ValueError(f"{name} is on {t.device}, raw on {raw.device}")
    if taps_rev.dim() != 1 or taps_rev.shape[0] < 1:
        raise ValueError("taps_rev must be a non-empty 1-D tensor")
    if rot.numel() != 1 or c_prev.numel() != 1:
        raise ValueError("rot and c_prev must hold one value each")
    k = int(taps_rev.shape[0])
    if int(stride) < 1 or int(out_len) < 1:
        raise ValueError(f"stride {stride} and out_len {out_len} must be >= 1")
    need = 2 * ((int(out_len) - 1) * int(stride) + k)
    if raw.shape[0] < need:
        raise ValueError(f"raw holds {raw.shape[0]} bytes, the windows "
                         f"need {need}")
    return k


def byte_tap_matrix(taps_rev: torch.Tensor) -> torch.Tensor:
    """(2K, 2) float32 matrix V with [Re c, Im c] = window_bytes @ V for the
    interleaved (I, Q) window of one output (the byte-domain tap vectors of
    BytePlan)."""
    k = taps_rev.shape[0]
    wr, wi = taps_rev.real.float(), taps_rev.imag.float()
    v = torch.empty(2 * k, 2, dtype=torch.float32, device=taps_rev.device)
    v[0::2, 0], v[1::2, 0] = wr, -wi
    v[0::2, 1], v[1::2, 1] = wi, wr
    return v


def ddc_fm_u8_plain(raw: torch.Tensor, taps_rev: torch.Tensor,
                    rot: torch.Tensor, c_prev: torch.Tensor, stride: int,
                    out_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The same contract in plain fp32 torch: each output's byte window
    (an `unfold` view) times the (2K, 2) byte-domain tap matrix, then the
    discriminator. Outputs go in chunks of `_PLAIN_CHUNK` so the window
    matrix stays small on any capture length."""
    k = _check(raw, taps_rev, rot, c_prev, stride, out_len)
    j = int(stride)
    v = byte_tap_matrix(taps_rev)
    rot = rot.reshape(1)
    audio = torch.empty(out_len, dtype=torch.float32, device=raw.device)
    cp = c_prev.reshape(1)
    for m0 in range(0, out_len, _PLAIN_CHUNK):
        m1 = min(out_len, m0 + _PLAIN_CHUNK)
        seg = raw[2 * m0 * j: 2 * ((m1 - 1) * j + k)].float() - 127.5
        win = seg.unfold(0, 2 * k, 2 * j)                  # (m1 - m0, 2K)
        c = torch.view_as_complex((win @ v).contiguous())
        prev = torch.cat([cp, c[:-1]])
        audio[m0:m1] = torch.angle(c * prev.conj() * rot)
        cp = c[-1:]
    return audio, cp.clone()


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        lib = _build.load("ddc_fm_u8")
        fn = lib.ddc_fm_u8_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Compile (or find) and load the kernel library."""
    _kernel_lib()


def ddc_fm_u8(raw: torch.Tensor, taps_rev: torch.Tensor, rot: torch.Tensor,
              c_prev: torch.Tensor, stride: int, out_len: int
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on the tensors' device: the CUDA kernel on a CUDA device, the
    plain version on the CPU. Returns (audio (out_len,) float32, c_last (1,)
    complex64)."""
    global LAUNCHES
    if raw.device.type == "cpu":
        return ddc_fm_u8_plain(raw, taps_rev, rot, c_prev, stride, out_len)
    if raw.device.type != "cuda":
        raise ValueError(f"ddc_fm_u8 runs on cuda or cpu, not {raw.device}")
    k = _check(raw, taps_rev, rot, c_prev, stride, out_len)
    lib = _kernel_lib()
    audio = torch.empty(out_len, dtype=torch.float32, device=raw.device)
    c_last = torch.empty(1, dtype=torch.complex64, device=raw.device)
    stream = torch.cuda.current_stream(raw.device).cuda_stream
    err = lib.ddc_fm_u8_launch(
        raw.data_ptr(), taps_rev.data_ptr(), k, int(stride), int(out_len),
        rot.data_ptr(), c_prev.data_ptr(), audio.data_ptr(),
        c_last.data_ptr(), raw.device.index, stream)
    if err != 0:
        raise RuntimeError(f"ddc_fm_u8 kernel launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return audio, c_last
