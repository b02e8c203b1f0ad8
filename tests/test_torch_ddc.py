"""K1 (`directdemod_tpu_torch.ops.ddc`) against the JAX package: the Pallas
u8 kernel in interpret mode, the dense byte-matmul lowering
(`BytePlan.apply_dot`) and the fp64 `BytePlan.oracle`, on the same bytes.

Tolerances, each the JAX suite's own: fp32 against the fp64 oracle < 5e-4
rad on the audio (tests/test_pallas.py:64); fp32 against fp32 compares
wrapped phase differences, 99.9th percentile < 1e-4 and max < 2e-2 (the
discriminator amplifies rounding where |c| is tiny, tests/test_ddc_conv.py:
89-90); the carried c_last < 5e-6 relative to the largest |c|
(tests/test_ddc_conv.py:49)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu.ops.ddc_conv import byte_plan, ddc_fm_bytes
from directdemod_tpu.ops.pallas_ddc import TILE, ddc_fm_pallas_u8
from directdemod_tpu_torch.ops import ddc

torch.set_num_threads(1)


def _consts():
    fe = JDdcFm(2048000, 30000, jdesign.blackmanharris(151), 60000, fm=True)
    return fe, np.asarray(fe.taps_mod[::-1], np.complex64), np.complex64(fe.rot)


def _port(raw, w, rot, cp, j, out_len):
    audio, c_last = ddc.ddc_fm_u8(
        torch.from_numpy(raw), torch.from_numpy(w),
        torch.tensor([rot]), torch.from_numpy(cp), j, out_len)
    return audio.numpy(), c_last.numpy()


def _wrapped(a, b):
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - b))))


def _oracle_audio(plan, raw, out_len, cp, rot):
    c = plan.oracle(raw, out_len)
    prev = np.concatenate([cp.astype(np.complex128), c[:-1]])
    return np.angle(c * np.conj(prev) * complex(rot)), c


@pytest.mark.parametrize("out_len", [1, TILE - 1, 3 * TILE + 17])
def test_plain_matches_pallas_u8_and_oracle(rng, out_len):
    fe, w, rot = _consts()
    j, k = fe.stride, len(fe.taps)
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k)).astype(np.uint8)
    cp = np.asarray([1.0 + 0.5j], np.complex64)
    a_port, c_port = _port(raw, w, rot, cp, j, out_len)
    a_jax, c_jax = ddc_fm_pallas_u8(jnp.asarray(raw), jnp.asarray(w),
                                    jnp.asarray(rot), jnp.asarray(cp), j,
                                    out_len, True)
    assert a_port.shape == (out_len,) and a_port.dtype == np.float32
    d = _wrapped(a_port, np.asarray(a_jax))
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2
    ref, c = _oracle_audio(byte_plan(fe.taps_mod[::-1], j), raw, out_len, cp, rot)
    assert _wrapped(a_port, ref).max() < 5e-4
    scale = np.max(np.abs(c))
    assert abs(complex(c_port[0]) - c[-1]) / scale < 5e-6
    assert abs(complex(c_port[0]) - complex(np.asarray(c_jax)[0])) / scale < 5e-6


def test_plain_matches_byte_plan_dot(rng):
    """The dense byte-matmul lowering (the TPU's default backend) on a
    ragged length that is not a multiple of its 32-output group."""
    fe, w, rot = _consts()
    j, k = fe.stride, len(fe.taps)
    out_len = 517
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k) + 32).astype(np.uint8)
    cp = np.asarray([-3.0 + 2.0j], np.complex64)
    plan = byte_plan(fe.taps_mod[::-1], j)
    a_jax, c_jax = ddc_fm_bytes(plan, jnp.asarray(raw), jnp.asarray(rot),
                                jnp.asarray(cp), out_len)
    a_port, c_port = _port(raw, w, rot, cp, j, out_len)
    d = _wrapped(a_port, np.asarray(a_jax))
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2
    ref, c = _oracle_audio(plan, raw, out_len, cp, rot)
    assert _wrapped(a_port, ref).max() < 5e-4
    assert abs(complex(c_port[0]) - c[-1]) / np.max(np.abs(c)) < 5e-6


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plain_chunking_carries_c(rng, monkeypatch, chunk):
    """The plain version's chunk loop hands c across chunk boundaries: any
    chunk size gives the one-chunk result."""
    fe, w, rot = _consts()
    j, k = fe.stride, len(fe.taps)
    out_len = 300
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k)).astype(np.uint8)
    cp = np.asarray([2.0 - 1.0j], np.complex64)
    whole, c_whole = _port(raw, w, rot, cp, j, out_len)
    monkeypatch.setattr(ddc, "_PLAIN_CHUNK", chunk)
    parts, c_parts = _port(raw, w, rot, cp, j, out_len)
    d = _wrapped(parts, whole)
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2
    assert abs(complex(c_parts[0]) - complex(c_whole[0])) < 1e-2


def test_odd_stride_and_taps(rng):
    """A stride and tap count other than the NOAA chain's (J=25, K=101)
    against the fp64 oracle."""
    j, k = 25, 101
    taps = jdesign.blackmanharris(k)
    wn = 2.0 * np.pi * 12000.0 / 1_000_000.0
    w = (taps * np.exp(1j * wn * np.arange(k)))[::-1]
    rot = np.complex64(np.exp(-1j * wn * j))
    out_len = 201
    raw = rng.integers(0, 256, 2 * ((out_len - 1) * j + k) + 7).astype(np.uint8)
    cp = np.asarray([1.0 + 0j], np.complex64)
    a_port, _ = _port(raw, w.astype(np.complex64), rot, cp, j, out_len)
    ref, _ = _oracle_audio(byte_plan(w, j), raw, out_len, cp, rot)
    assert _wrapped(a_port, ref).max() < 5e-4


def test_cpu_tensors_run_the_plain_version():
    """On the CPU the wrapper runs the plain version and counts no launch."""
    fe, w, rot = _consts()
    j, k = fe.stride, len(fe.taps)
    raw = np.random.default_rng(1).integers(0, 256, 2 * (9 * j + k)).astype(np.uint8)
    cp = np.asarray([1.0 + 0j], np.complex64)
    before = ddc.LAUNCHES
    a, c = _port(raw, w, rot, cp, j, 10)
    a_p, c_p = ddc.ddc_fm_u8_plain(torch.from_numpy(raw), torch.from_numpy(w),
                                   torch.tensor([rot]), torch.from_numpy(cp),
                                   j, 10)
    assert ddc.LAUNCHES == before
    assert np.array_equal(a, a_p.numpy()) and np.array_equal(c, c_p.numpy())


def _args(k=151, j=34, out_len=10):
    raw = torch.zeros(2 * ((out_len - 1) * j + k), dtype=torch.uint8)
    return [raw, torch.ones(k, dtype=torch.complex64),
            torch.ones(1, dtype=torch.complex64),
            torch.ones(1, dtype=torch.complex64), j, out_len]


@pytest.mark.parametrize("bad", [
    lambda a: a.__setitem__(0, a[0].float()),              # raw not uint8
    lambda a: a.__setitem__(0, a[0][:-1]),                 # raw too short
    lambda a: a.__setitem__(0, a[0].reshape(2, -1)),       # raw not 1-D
    lambda a: a.__setitem__(0, torch.zeros(2 * a[0].shape[0],
                                           dtype=torch.uint8)[::2]),  # strided
    lambda a: a.__setitem__(1, a[1].to(torch.complex128)),  # taps dtype
    lambda a: a.__setitem__(2, torch.ones(2, dtype=torch.complex64)),  # rot size
    lambda a: a.__setitem__(5, 0),                         # no outputs
    lambda a: a.__setitem__(4, 0),                         # stride 0
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    args = _args()
    bad(args)
    with pytest.raises(ValueError):
        ddc.ddc_fm_u8(*args)
