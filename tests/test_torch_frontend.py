"""The port's front end (`models/frontend.py`) against the JAX package:
`DdcFm.process` over a multi-block raw capture (block 0 through
`fir_decimate`, later blocks through K1's plain version), the resident
front end, and the stream carry handed over from a JAX stream to the port.

On the CPU the JAX `DdcFmStream(backend="auto")` runs the XLA polyphase
path, so the port's K1 blocks are held to that, and the resident front end
to the JAX resident front end (its dense byte-matmul lowering). Both sides
are fp32; the bars are the JAX suite's for fp32 phase outputs: 99.9th
percentile of the wrapped difference < 1e-4 and max < 2e-2
(tests/test_pallas.py:86-87)."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import IQDat as JIQDat
from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.models.frontend import DdcFmStream as JDdcFmStream
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu_torch.io import sources
from directdemod_tpu_torch.models import frontend
from directdemod_tpu_torch.models.frontend import DdcFm, DdcFmStream
from directdemod_tpu_torch.ops import ddc, design

torch.set_num_threads(1)

FS, OFF, BW = 2048000, 30000, 60000


def _fes():
    return (DdcFm(FS, OFF, design.blackmanharris(151), BW),
            JDdcFm(FS, OFF, jdesign.blackmanharris(151), BW, fm=True))


def _assert_phase_close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - ref))))
    assert np.percentile(d, 99.9) < 1e-4, np.percentile(d, 99.9)
    assert d.max() < 2e-2, d.max()


def test_constants_match_jax():
    fe, jfe = _fes()
    assert fe.stride == jfe.stride and fe.out_rate == jfe.out_rate
    assert np.array_equal(fe.taps_mod, jfe.taps_mod)
    assert fe.rot == complex(jfe.rot)
    assert np.array_equal(fe.hist0, jfe.hist0)


@pytest.mark.parametrize("n,block", [(700_000, 200_000), (450_017, 150_000)])
def test_process_raw_blocks_match_jax(tmp_path, rng, n, block):
    """A raw .dat stream: block 0 through fir_decimate, the rest through
    K1 (plain version on the CPU) with the byte-history carry."""
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    p = tmp_path / "c.dat"
    raw.tofile(p)
    fe, jfe = _fes()
    before = ddc.LAUNCHES
    got, rate = fe.process(sources.IQDat(str(p), FS), block_size=block,
                           device="cpu")
    ref, jrate = jfe.process(JIQDat(str(p), FS), block_size=block)
    assert rate == jrate
    _assert_phase_close(got, ref)
    assert ddc.LAUNCHES == before            # the CPU never launches K1


def test_process_complex_source_matches_jax(rng):
    n = 300_000
    x = ((rng.integers(0, 256, n) - 127.5)
         + 1j * (rng.integers(0, 256, n) - 127.5)).astype(np.complex64)
    fe, jfe = _fes()
    got, _ = fe.process(sources.ArraySource(x, FS), block_size=120_000,
                        device="cpu")
    ref, _ = jfe.process(JArraySource(x, FS), block_size=120_000)
    _assert_phase_close(got, ref)


def test_resident_frontend_matches_jax(rng, monkeypatch):
    """Block 0 through fir_decimate and the whole remainder in one K1 call
    (block 0 shortened from 20 M samples so the K1 arm runs), against the
    JAX resident front end and the JAX blocked stream."""
    n = 420_000
    raw = rng.integers(0, 256, 2 * n).astype(np.uint8)
    fe, jfe = _fes()
    monkeypatch.setattr(frontend.constants, "PROC_CHUNKSIZE", 150_000)
    got = fe.resident_frontend(torch.from_numpy(raw), n).numpy()
    ref = np.asarray(jfe.resident_frontend(jnp.asarray(raw), n))
    _assert_phase_close(got, ref)
    stream = JDdcFmStream(jfe)
    blocked = np.concatenate([
        np.asarray(stream.step(jnp.asarray(raw[2 * s: 2 * min(s + 100_000, n)]), s))
        for s in range(0, n, 100_000)])
    _assert_phase_close(got, blocked)


@pytest.mark.parametrize("raw_carry", [True, False])
def test_state_handover_from_jax(rng, raw_carry):
    """The first blocks run in JAX; its carry (conv history, last conv
    output, and for a raw stream the tail bytes) goes over as numpy, the
    port finishes the stream, and the output matches the all-JAX run."""
    n_blk, blocks, handover = 120_000, 4, 2
    raw = rng.integers(0, 256, 2 * n_blk * blocks).astype(np.uint8)
    fe, jfe = _fes()

    def block(i):
        seg = raw[2 * i * n_blk: 2 * (i + 1) * n_blk]
        if raw_carry:
            return seg
        return ((seg[0::2] - 127.5) + 1j * (seg[1::2] - 127.5)).astype(np.complex64)

    ref_stream = JDdcFmStream(jfe)
    ref = [np.asarray(ref_stream.step(jnp.asarray(block(i)), i * n_blk))
           for i in range(blocks)]

    jstream = JDdcFmStream(jfe)
    for i in range(handover):
        jstream.step(jnp.asarray(block(i)), i * n_blk)
    hist, c_last = jstream.state
    port = DdcFmStream(fe, "cpu")
    port.load_state(np.asarray(hist), np.asarray(c_last),
                    np.asarray(jstream.raw_hist) if raw_carry else None)
    for i in range(handover, blocks):
        got = port.step(torch.from_numpy(block(i)), i * n_blk).numpy()
        _assert_phase_close(got, ref[i])


def test_mixed_raw_then_complex_blocks(rng):
    """K1 blocks followed by a complex block: the conv history is rebuilt
    from the carried tail bytes."""
    n_blk = 100_000
    raw = rng.integers(0, 256, 2 * n_blk * 3).astype(np.uint8)
    fe, jfe = _fes()
    jstream = JDdcFmStream(jfe)
    stream = DdcFmStream(fe, "cpu")
    for i in range(3):
        seg = raw[2 * i * n_blk: 2 * (i + 1) * n_blk]
        ref = np.asarray(jstream.step(jnp.asarray(seg), i * n_blk))
        x = torch.from_numpy(seg)
        if i == 2:
            x = torch.complex(x[0::2].float() - 127.5, x[1::2].float() - 127.5)
        _assert_phase_close(stream.step(x, i * n_blk).numpy(), ref)


def test_from_numpy_matches_designed_front_end(rng):
    """A front end built from the JAX object's host constants computes what
    the designed one computes."""
    fe, jfe = _fes()
    fe2 = DdcFm.from_numpy(jfe.taps_mod, jfe.rot, jfe.hist0, jfe.stride)
    raw = torch.from_numpy(rng.integers(0, 256, 2 * 250_000).astype(np.uint8))
    a, b = DdcFmStream(fe, "cpu"), DdcFmStream(fe2, "cpu")
    for s in (0, 125_000):
        x = raw[2 * s: 2 * (s + 125_000)]
        assert torch.equal(a.step(x, s), b.step(x, s))
