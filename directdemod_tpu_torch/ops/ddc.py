"""K1 and K4: the fused DDC + FM front end step, for one or more channels.

Ports of the TPU kernels `directdemod_tpu/ops/pallas_ddc.py::_kernel_u8`
(K1, wrapper `ddc_fm_pallas_u8`, with its XLA lowering
`directdemod_tpu/ops/ddc_conv.py::BytePlan.apply_dot`) and
`directdemod_tpu/ops/pallas_ddc.py::_kernel` (K4, wrapper `ddc_fm_pallas`),
with the channel axis of `directdemod_tpu/models/multichannel.py`. Per
channel ch, output m is

    c[ch, m]     = sum_n w[ch, n] x[m*J + n]
    audio[ch, m] = angle(c[ch, m] * conj(c[ch, m-1]) * rot[ch]),  c[ch, -1] = c_prev[ch]

with `w` the reversed NCO-modulated taps. K1 reads raw interleaved uint8
IQ, x[s] = raw[2s] - 127.5 + 1j (raw[2s+1] - 127.5), so output m reads bytes
raw[2*m*J .. 2*(m*J+K)); K4 reads complex64 samples. Both return (audio,
c_last) with c_last = c[:, out_len - 1], the carry of the next block (the
JAX K4 returns the carry at the end of its 512-output tile grid instead).
With 1-D taps (one channel) audio is (out_len,) and c_last (1,); with (C, K)
taps, rot and c_prev are (C,), audio (C, out_len) and c_last (C,). An
optional `head` (the same dtype) holds samples that precede x: the windows
then run over [head | x], which the kernels read in place, so a stream puts
its history in front of a block without copying the block.

`ddc_fm_u8` and `ddc_fm_c64` launch the CUDA kernels `csrc/ddc_fm_u8.cu`
and `csrc/ddc_fm_c64.cu` for tensors on a CUDA device and run their plain
versions for tensors on the CPU; any other device raises. There is no
fallback from a kernel to its plain version. `launch_plan` reports what a
launch chooses on the card (threads a block, passes, the skewed layout,
resident blocks an SM, blocks).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# Kernel launches in this process (the plain versions do not count).
LAUNCHES = 0        # K1
LAUNCHES_C64 = 0    # K4

_PLAIN_CHUNK = 1 << 16      # outputs per window matrix in the plain K1


def _check(x: torch.Tensor, dtype, taps_rev: torch.Tensor, rot: torch.Tensor,
           c_prev: torch.Tensor, stride: int, out_len: int,
           head: torch.Tensor | None = None) -> tuple[int, int]:
    """Validate the kernels' argument contract; returns (C, K)."""
    parts = (x,) if head is None else (head, x)
    for t in parts:
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"the input must be a contiguous 1-D {dtype} tensor")
        if t.device != x.device:
            raise ValueError(f"head is on {t.device}, the input on {x.device}")
        if dtype == torch.uint8 and (t.data_ptr() % 2
                                     or (t is head and t.shape[0] % 2)):
            raise ValueError("raw bytes must start on an (I, Q) pair boundary "
                             "(an even address), and a head hold whole pairs")
    for name, t in (("taps_rev", taps_rev), ("rot", rot), ("c_prev", c_prev)):
        if t.dtype != torch.complex64 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous complex64 tensor")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, the input on {x.device}")
    if taps_rev.dim() not in (1, 2) or taps_rev.shape[-1] < 1:
        raise ValueError("taps_rev must be (K,) or (C, K) with K >= 1")
    c = 1 if taps_rev.dim() == 1 else int(taps_rev.shape[0])
    if c < 1 or rot.numel() != c or c_prev.numel() != c:
        raise ValueError(f"rot and c_prev must hold one value a channel ({c})")
    k = int(taps_rev.shape[-1])
    if int(stride) < 1 or int(out_len) < 1:
        raise ValueError(f"stride {stride} and out_len {out_len} must be >= 1")
    need = (int(out_len) - 1) * int(stride) + k
    have = sum(t.shape[0] for t in parts)
    if have < (2 * need if dtype == torch.uint8 else need):
        raise ValueError(f"the input holds {have} elements, the windows "
                         f"need {need} samples")
    return c, k


def _shape_out(taps_rev, audio, c_last):
    if taps_rev.dim() == 1:
        return audio.reshape(-1), c_last.reshape(1)
    return audio, c_last


def _discriminate(c: torch.Tensor, rot: torch.Tensor, c_prev: torch.Tensor
                  ) -> torch.Tensor:
    """angle(c[:, m] conj(c[:, m-1]) rot) for (C, M) sums c, c[:, -1] = c_prev."""
    prev = torch.cat([c_prev.reshape(-1, 1), c[:, :-1]], dim=1)
    return torch.angle(c * prev.conj() * rot.reshape(-1, 1))


def byte_tap_matrix(taps_rev: torch.Tensor) -> torch.Tensor:
    """(2K, 2C) float32 matrix V with [Re c, Im c] of channel ch in columns
    2ch, 2ch+1 = window_bytes @ V for the interleaved (I, Q) window of one
    output (the byte-domain tap vectors of BytePlan); 1-D taps are C = 1."""
    t = taps_rev.reshape(-1, taps_rev.shape[-1])
    wr, wi = t.real.float().T, t.imag.float().T                 # (K, C)
    v = torch.empty(2 * t.shape[1], t.shape[0], 2, dtype=torch.float32,
                    device=taps_rev.device)
    v[0::2, :, 0], v[1::2, :, 0] = wr, -wi
    v[0::2, :, 1], v[1::2, :, 1] = wi, wr
    return v.reshape(2 * t.shape[1], 2 * t.shape[0])


def ddc_fm_u8_plain(raw: torch.Tensor, taps_rev: torch.Tensor,
                    rot: torch.Tensor, c_prev: torch.Tensor, stride: int,
                    out_len: int, head: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's contract in plain fp32 torch: each output's byte window (an
    `unfold` view) times the (2K, 2C) byte-domain tap matrix, then the
    discriminator. Outputs go in chunks of `_PLAIN_CHUNK` so the window
    matrix stays small on any capture length. A bank runs a channel at a
    time, so that each channel's outputs are those of its one-channel
    call bit for bit, as K1's are on the card (the CPU rounds a wider
    matrix product, and a longer discriminator row, otherwise)."""
    c, k = _check(raw, torch.uint8, taps_rev, rot, c_prev, stride, out_len, head)
    if taps_rev.dim() == 2 and c > 1:
        outs = [ddc_fm_u8_plain(raw, taps_rev[ch], rot[ch:ch + 1],
                                c_prev.reshape(c)[ch:ch + 1], stride, out_len, head)
                for ch in range(c)]
        return (torch.stack([a for a, _ in outs]),
                torch.cat([last for _, last in outs]))
    if head is not None:
        raw = torch.cat([head, raw])
    j = int(stride)
    v = byte_tap_matrix(taps_rev)
    audio = torch.empty(c, out_len, dtype=torch.float32, device=raw.device)
    cp = c_prev.reshape(c)
    for m0 in range(0, out_len, _PLAIN_CHUNK):
        m1 = min(out_len, m0 + _PLAIN_CHUNK)
        seg = raw[2 * m0 * j: 2 * ((m1 - 1) * j + k)].float() - 127.5
        win = seg.unfold(0, 2 * k, 2 * j)                  # (m1 - m0, 2K)
        cc = torch.view_as_complex((win @ v).reshape(m1 - m0, c, 2)).T
        audio[:, m0:m1] = _discriminate(cc, rot, cp)
        cp = cc[:, -1]
    return _shape_out(taps_rev, audio, cp.clone())


def conv_windows(x: torch.Tensor, taps_rev: torch.Tensor, stride: int,
                 out_len: int) -> torch.Tensor:
    """c[ch, m] = sum_n taps_rev[ch, n] x[m*stride + n] for complex x, as
    ONE real `F.conv1d` (the `fir.conv_valid` layout: re and im as two input
    channels, each channel's re and im outputs as two output channels);
    returns (C, out_len) complex."""
    t = taps_rev.reshape(-1, taps_rev.shape[-1])
    k = t.shape[1]
    wr, wi = t.real, t.imag
    weight = torch.stack([torch.stack([wr, -wi], 1),
                          torch.stack([wi, wr], 1)], 1).reshape(-1, 2, k)
    seg = x[: (out_len - 1) * stride + k]
    xs = torch.view_as_real(seg).T.reshape(1, 2, -1)
    y = F.conv1d(xs, weight.to(xs.dtype), stride=stride)
    y = y.reshape(t.shape[0], 2, -1)
    return torch.complex(y[:, 0], y[:, 1])


def ddc_fm_c64_plain(x: torch.Tensor, taps_rev: torch.Tensor,
                     rot: torch.Tensor, c_prev: torch.Tensor, stride: int,
                     out_len: int, head: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's contract in plain fp32 torch: the windows as one `F.conv1d`
    (`conv_windows`, the arithmetic of `fir.conv_valid`), then the
    discriminator."""
    c, _ = _check(x, torch.complex64, taps_rev, rot, c_prev, stride, out_len, head)
    if head is not None:
        x = torch.cat([head, x])
    cc = conv_windows(x, taps_rev, int(stride), int(out_len))
    audio = _discriminate(cc, rot, c_prev.reshape(c))
    return _shape_out(taps_rev, audio, cc[:, -1].clone())


_libs: dict = {}


def _kernel_fn(name: str):
    fn = _libs.get(name)
    if fn is None:
        fn = getattr(_build.load(name), name + "_launch")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _libs[name] = fn
    return fn


PLAN_FIELDS = ("T", "S", "skew", "L", "smem", "passes", "blocks_per_sm", "grid")


def launch_plan(name: str, channels: int, ntaps: int, stride: int, out_len: int,
                device: int = 0) -> dict:
    """What kernel `name` ("ddc_fm_u8" or "ddc_fm_c64") chooses for a launch
    of `channels` channels of `ntaps` taps at `stride` over `out_len`
    outputs on CUDA device `device`: threads a block T, span samples a pass
    S, the skewed layout (skew, 1 or 0), tap positions a channel L, shared
    bytes a block (smem), passes a tile, resident blocks an SM and blocks
    (grid; each walks tiles of T - 1 new outputs), as `PLAN_FIELDS` keys."""
    fn = _libs.get(name + "_plan")
    if fn is None:
        fn = getattr(_build.load(name), name + "_plan")
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        fn.restype = ctypes.c_int
        _libs[name + "_plan"] = fn
    out = (ctypes.c_longlong * len(PLAN_FIELDS))()
    err = fn(int(channels), int(ntaps), int(stride), int(out_len), int(device), out)
    if err != 0:
        raise RuntimeError(f"{name} launch plan failed: cudaError_t {err}")
    return dict(zip(PLAN_FIELDS, out))


def build() -> None:
    """Compile (or find) and load both kernel libraries."""
    _kernel_fn("ddc_fm_u8")
    _kernel_fn("ddc_fm_c64")


def _launch(name: str, x, dtype, taps_rev, rot, c_prev, stride, out_len, head):
    c, k = _check(x, dtype, taps_rev, rot, c_prev, stride, out_len, head)
    audio = torch.empty(c, out_len, dtype=torch.float32, device=x.device)
    c_last = torch.empty(c, dtype=torch.complex64, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    n_head = 0 if head is None else head.shape[0] // (2 if dtype == torch.uint8 else 1)
    err = _kernel_fn(name)(
        None if head is None else head.data_ptr(), n_head, x.data_ptr(),
        taps_rev.data_ptr(), c, k, int(stride), int(out_len),
        rot.data_ptr(), c_prev.data_ptr(), audio.data_ptr(), c_last.data_ptr(),
        x.device.index, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")
    return _shape_out(taps_rev, audio, c_last)


def _where(x: torch.Tensor, name: str) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x.device}")
    return x.device.type


def ddc_fm_u8(raw: torch.Tensor, taps_rev: torch.Tensor, rot: torch.Tensor,
              c_prev: torch.Tensor, stride: int, out_len: int,
              head: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 on the tensors' device: the CUDA kernel on a CUDA device, the
    plain version on the CPU."""
    global LAUNCHES
    if _where(raw, "ddc_fm_u8") == "cpu":
        return ddc_fm_u8_plain(raw, taps_rev, rot, c_prev, stride, out_len, head)
    out = _launch("ddc_fm_u8", raw, torch.uint8, taps_rev, rot, c_prev,
                  stride, out_len, head)
    LAUNCHES += 1
    return out


def ddc_fm_c64(x: torch.Tensor, taps_rev: torch.Tensor, rot: torch.Tensor,
               c_prev: torch.Tensor, stride: int, out_len: int,
               head: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """K4 on the tensors' device: the CUDA kernel on a CUDA device, the
    plain version on the CPU."""
    global LAUNCHES_C64
    if _where(x, "ddc_fm_c64") == "cpu":
        return ddc_fm_c64_plain(x, taps_rev, rot, c_prev, stride, out_len, head)
    out = _launch("ddc_fm_c64", x, torch.complex64, taps_rev, rot, c_prev,
                  stride, out_len, head)
    LAUNCHES_C64 += 1
    return out
