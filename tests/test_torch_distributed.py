"""The port's mesh over two processes (`directdemod_tpu_torch.parallel.
distributed`) on the CPU, over gloo: the counterpart of the JAX package's
`tests/test_distributed.py`, which runs the production sharded front end
and then a whole NOAA decode over 2 processes x 4 devices.

Two worker processes (`distributed.launch`, a free localhost port, every
wait bounded) each take 4 CPU shards of an 8-shard `time` mesh and write
what they computed to files; the JAX references and the one-process runs
are computed here, in the test process. The workers import torch and the
port only.

Stated tolerances:
- the two-process front end (complex64 and raw bytes, `_wave` and
  `process`) equals the one-process 8-shard port run bit for bit (only the
  transport of the halos differs), and equals JAX `DdcFm.process` on the
  same input within the JAX test's bar (max |difference| < 2e-3,
  tests/test_distributed.py:77) and the front-end tests' wrapped-phase bar
  (99.9th percentile < 1e-4, max < 2e-2);
- the collectives across processes move values exactly;
- NOAA on the two-process mesh, rank 0 against the port's unsharded decode
  (the JAX two-process test's bars, tests/test_distributed.py:129-134):
  crude syncs equal, >= 99.9 % of pixels equal, none off by more than 1;
  its crude syncs equal the JAX unsharded decoder's; both ranks return the
  same image.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from directdemod_tpu.io.sources import ArraySource as JArraySource
from directdemod_tpu.io.sources import IQDat as JIQDat
from directdemod_tpu.models.frontend import DdcFm as JDdcFm
from directdemod_tpu.models.noaa import NoaaDecoder as JNoaaDecoder
from directdemod_tpu.ops import design as jdesign
from directdemod_tpu_torch.io.sources import ArraySource, IQDat
from directdemod_tpu_torch.models.frontend import DdcFm
from directdemod_tpu_torch.models.noaa import NoaaDecoder
from directdemod_tpu_torch.ops import design
from directdemod_tpu_torch.parallel import distributed
from directdemod_tpu_torch.parallel.mesh import make_mesh
from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
from tests.apt_synth import synthesize

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FS = 2048000
L = 100_000
N_CHUNKS = 8
WORKER_TIMEOUT_S = 120

_WORKER = r"""
import json, os, sys
case, rank, world, port, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
import numpy as np
import torch
torch.set_num_threads(1)
from directdemod_tpu_torch.parallel import distributed
from directdemod_tpu_torch.parallel import mesh as pmesh

FS, L, N = 2048000, 100_000, 8
distributed.initialize("127.0.0.1:" + port, world, rank, local_devices=4, device="cpu")
mesh = pmesh.make_mesh(time=8)
mine = mesh.local_time
res = {}

def raises(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None

if case == "frontend":
    from directdemod_tpu_torch.io.sources import ArraySource, IQDat
    from directdemod_tpu_torch.models.frontend import DdcFm
    from directdemod_tpu_torch.ops import design
    from directdemod_tpu_torch.parallel.sharded import ShardedDdcFm
    x = np.load(os.path.join(out, "x.npy"))
    raw = np.load(os.path.join(out, "raw.npy"))
    fe = DdcFm(FS, 30000, design.blackmanharris(151), 60000)
    sh = ShardedDdcFm(fe, mesh)
    starts = [i * L for i in range(N)]
    for kind, stack in (("c64", x[:N * L].reshape(N, L)),
                        ("u8", raw[:2 * N * L].reshape(N, 2 * L))):
        ys, carry = sh._wave(distributed.global_wave(mesh, stack[mine]), starts, None)
        for i in mine:
            res[f"wave_{kind}_{i}"] = ys[i][0].numpy()
        res[f"wave_{kind}_carry"] = np.asarray(carry is not None)
    res["process_c64"], _ = sh.process(ArraySource(x, FS), L)
    res["process_u8"], _ = sh.process(IQDat(os.path.join(out, "raw.dat"), FS), L)
    # the collectives across processes
    xs = [torch.full((3,), float(i)) if mesh.is_local(i) else None for i in range(N)]
    ring = pmesh.ppermute(xs, [(i, (i + 1) % N) for i in range(N)], mesh.time_devices,
                          mesh.time_ranks)
    part = pmesh.ppermute(xs, [(0, 5), (6, 1)], mesh.time_devices, mesh.time_ranks)
    gat = pmesh.all_gather(xs, mesh.time_devices, mesh.time_ranks)
    for i in range(N):
        res[f"ring_{i}"] = np.asarray(ring[i] is None if not mesh.is_local(i) else ring[i].numpy())
        res[f"part_{i}"] = np.asarray(part[i] is None if not mesh.is_local(i) else part[i].numpy())
        res[f"gather_{i}"] = np.asarray(gat[i] is None if not mesh.is_local(i) else gat[i].numpy())
    res["gather_host"] = np.asarray(sorted(pmesh.gather_host(mesh, {rank: np.arange(rank + 2)})))
    # what must raise on a mesh that spans processes
    from directdemod_tpu_torch.models.funcube import FuncubeDecoder
    from directdemod_tpu_torch.models.multichannel import MultiDdcFm
    from directdemod_tpu_torch.ops import pll
    from directdemod_tpu_torch.parallel.dryrun import dryrun
    from directdemod_tpu_torch.stream.api import Stream
    from directdemod_tpu_torch import cli
    taps = design.blackmanharris(151)
    src = ArraySource(x, FS)
    p = pll.PskParams(fs=FS, sym_rate=12000, qpsk=False, agc_mean0=180.0,
                      agc_gain_cap=20.0, costas_bw=0.3141, minsync_thresh=120.0)
    sync = np.ones(12, dtype=np.int64)
    msgs = {
        "global_wave": raises(lambda: distributed.global_wave(mesh, x[:3 * L].reshape(3, L))),
        "make_mesh_time": raises(lambda: pmesh.make_mesh(time=1, channel=8)),
        "make_mesh_count": raises(lambda: pmesh.make_mesh(time=6)),
        "multichannel": raises(lambda: MultiDdcFm(FS, (30000.0, -12000.0), taps, 60000, mesh=mesh)),
        "symbol_scan_segments": raises(lambda: pll.symbol_scan_segments(
            p, torch.zeros(40_000, dtype=torch.complex64), sync, sync, 8, 8, mesh=mesh)),
        "funcube": raises(lambda: FuncubeDecoder(src, 5000, device="cpu", mesh=mesh)),
        "run_sharded": raises(lambda: Stream(src, device="cpu").shift(30000).filter(taps)
                              .bw_limit(60000).fm_demod().run_sharded(mesh)),
        "dryrun": raises(lambda: dryrun(8, device="cpu")),
        "cli": raises(lambda: cli.main(["--mesh=2", "-d", "noaa", os.path.join(out, "none.wav")],
                                       device="cpu")),
    }
    with open(os.path.join(out, f"msgs_{rank}.json"), "w") as f:
        json.dump(msgs, f)
elif case == "noaa":
    from directdemod_tpu_torch.io.sources import ArraySource
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    iq = np.load(os.path.join(out, "iq.npy"))
    dec = NoaaDecoder(ArraySource(iq, FS), 30000, device="cpu", mesh=mesh)
    res["useful"] = np.asarray(dec.useful)
    res["sync_a"], res["sync_b"] = dec.get_crude_sync()
    res["image"] = dec.get_image()
    acc = dec.get_accurate_sync()
    res["acc_a"], res["acc_b"] = np.asarray(acc[0]), np.asarray(acc[4])
np.savez(os.path.join(out, f"{case}_{rank}.npz"), **res)
distributed.shutdown()
assert not any(m == "jax" or m.startswith(("jax.", "directdemod_tpu.")) for m in sys.modules)
print(f"rank {rank}: {case} OK", flush=True)
"""


def _run_workers(tmp_path, case: str) -> list:
    """Start the two ranks of `case` and return what each wrote."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    port = str(distributed.free_port())
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    results = distributed.launch(
        [[str(script), case, str(rank), "2", port, str(tmp_path)] for rank in range(2)],
        timeout_s=WORKER_TIMEOUT_S, env=env, cwd=str(tmp_path))
    logs = "".join(f"\n--- rank {rank} exit {code}:\n{text[-3000:]}"
                   for rank, (code, text) in enumerate(results))
    for rank, (code, text) in enumerate(results):
        assert code == 0 and f"rank {rank}: {case} OK" in text, logs
    return [dict(np.load(tmp_path / f"{case}_{rank}.npz")) for rank in range(2)]


def _capture() -> np.ndarray:
    """The JAX test's signal (seed 11, 8 chunks of 100,000 samples), one
    chunk and a ragged 777 samples longer, so that `process` also runs a
    remainder after the wave."""
    rng = np.random.default_rng(11)
    n = N_CHUNKS * L + L + 777
    t = np.arange(n) / FS
    x = (np.exp(1j * (2 * np.pi * 30000 * t + 3 * np.sin(2 * np.pi * 400 * t)))
         + 0.1 * (rng.standard_normal(n) + 1j * rng.standard_normal(n)))
    return x.astype(np.complex64)


def _bytes(x: np.ndarray, scale: float = 60.0) -> np.ndarray:
    b = np.empty(2 * len(x), np.uint8)
    b[0::2] = np.clip(np.round(x.real * scale + 127.5), 0, 255)
    b[1::2] = np.clip(np.round(x.imag * scale + 127.5), 0, 255)
    return b


def _fe():
    return DdcFm(FS, 30000, design.blackmanharris(151), 60000)


def _jfe():
    return JDdcFm(FS, 30000, jdesign.blackmanharris(151), 60000, fm=True)


def _assert_phase_close(got, ref):
    assert got.shape == ref.shape, (got.shape, ref.shape)
    d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - ref))))
    assert np.percentile(d, 99.9) < 1e-4 and d.max() < 2e-2, d.max()


@pytest.fixture(scope="module")
def frontend_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("frontend")
    x = _capture()
    raw = _bytes(x)
    np.save(tmp / "x.npy", x)
    np.save(tmp / "raw.npy", raw)
    raw.tofile(tmp / "raw.dat")
    ranks = _run_workers(tmp, "frontend")
    msgs = [json.loads((tmp / f"msgs_{r}.json").read_text()) for r in range(2)]
    return x, raw, tmp, ranks, msgs


def _one_process_wave(stack) -> list:
    mesh = make_mesh(time=N_CHUNKS, device="cpu")
    chunks = [torch.from_numpy(np.ascontiguousarray(c)) for c in stack]
    ys, _ = ShardedDdcFm(_fe(), mesh)._wave(chunks, [i * L for i in range(N_CHUNKS)], None)
    return [y.numpy() for y, _ in ys]


def _two_process_rows(ranks, kind) -> list:
    return [ranks[i // 4][f"wave_{kind}_{i}"] for i in range(N_CHUNKS)]


def test_two_process_wave_complex64(frontend_run):
    """`global_wave` + `ShardedDdcFm._wave` over 2 processes x 4 shards:
    each rank's rows equal the one-process 8-shard run bit for bit and JAX
    `DdcFm.process` within the JAX test's bar."""
    x, _, _, ranks, _ = frontend_run
    rows = _two_process_rows(ranks, "c64")
    want = _one_process_wave(x[:N_CHUNKS * L].reshape(N_CHUNKS, L))
    for got, ref in zip(rows, want):
        assert got.dtype == ref.dtype and np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    jref, _ = _jfe().process(JArraySource(x[:N_CHUNKS * L], FS), block_size=L,
                             dtype=jnp.complex64)
    got = np.concatenate(rows)
    assert got.shape == jref.shape
    assert np.max(np.abs(got - jref)) < 2e-3
    _assert_phase_close(got, jref)
    # shard 0's owner holds the next wave's carry, the other rank none
    assert bool(ranks[0]["wave_c64_carry"]) and not bool(ranks[1]["wave_c64_carry"])


def test_two_process_wave_raw_bytes(frontend_run):
    """The same over raw uint8 bytes (K1's plain version on each shard, the
    halo as bytes staged through the host)."""
    _, raw, _, ranks, _ = frontend_run
    rows = _two_process_rows(ranks, "u8")
    want = _one_process_wave(raw[:2 * N_CHUNKS * L].reshape(N_CHUNKS, 2 * L))
    for got, ref in zip(rows, want):
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    jref, _ = _jfe().process(JArraySource(_u8_to_c64(raw[:2 * N_CHUNKS * L]), FS),
                             block_size=L, dtype=jnp.complex64)
    _assert_phase_close(np.concatenate(rows), jref)


def _u8_to_c64(raw):
    f = raw.astype(np.float32)
    return ((f[0::2] - np.float32(127.5)) + 1j * (f[1::2] - np.float32(127.5))
            ).astype(np.complex64)


@pytest.mark.parametrize("kind", ["c64", "u8"])
def test_process_returns_the_whole_array_on_both_ranks(frontend_run, kind):
    """`ShardedDdcFm.process` over a capture with a remainder after the
    wave (each rank reads its own blocks; the remainder runs on shard 0's
    owner): both ranks return the one-process mesh's array bit for bit."""
    x, raw, tmp, ranks, _ = frontend_run
    src = (ArraySource(x, FS) if kind == "c64" else IQDat(str(tmp / "raw.dat"), FS))
    want, _ = ShardedDdcFm(_fe(), make_mesh(time=N_CHUNKS, device="cpu")).process(src, L)
    for r in range(2):
        got = ranks[r][f"process_{kind}"]
        assert got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), r
    if kind == "u8":
        jref, _ = _jfe().process(JIQDat(str(tmp / "raw.dat"), FS), block_size=L)
        _assert_phase_close(want, jref)


def test_ppermute_and_all_gather_across_processes(frontend_run):
    """A ring (every pair of neighbours, two of them across processes), a
    partial permutation (receivers with no sender get zeros, as in JAX) and
    an all-gather; each rank holds only its own shards' results."""
    ranks = frontend_run[3]
    for i in range(N_CHUNKS):
        own, other = ranks[i // 4], ranks[1 - i // 4]
        assert np.array_equal(own[f"ring_{i}"], np.full(3, float((i - 1) % N_CHUNKS)))
        want = {5: 0.0, 1: 6.0}.get(i, 0.0)
        assert np.array_equal(own[f"part_{i}"], np.full(3, want))
        assert np.array_equal(own[f"gather_{i}"],
                              np.repeat(np.arange(8.0)[:, None], 3, axis=1))
        assert bool(other[f"ring_{i}"]) and bool(other[f"gather_{i}"])   # None there
    for r in range(2):
        assert list(ranks[r]["gather_host"]) == [0, 1]


@pytest.mark.parametrize("name,match", [
    ("global_wave", "3 local chunks for the 4 time shards"),
    ("make_mesh_time", "time axis 1 is not a multiple of the 2 processes"),
    ("make_mesh_count", "6x1 mesh needs 6 devices, have 8"),
])
def test_global_wave_and_make_mesh_raise(frontend_run, name, match):
    for msgs in frontend_run[4]:
        assert msgs[name] is not None and match in msgs[name], msgs[name]


@pytest.mark.parametrize("name", ["multichannel", "symbol_scan_segments", "funcube",
                                  "run_sharded", "dryrun", "cli"])
def test_one_process_callers_raise_on_a_process_mesh(frontend_run, name):
    """The `mesh=` callers the JAX suite does not test across processes
    raise ValueError there, naming the missing support."""
    for msgs in frontend_run[4]:
        assert msgs[name] is not None and "process" in msgs[name], msgs[name]


def test_a_mesh_without_initialize_is_one_process():
    """Without `initialize` a mesh is one process's: every shard local."""
    m = make_mesh(time=8, device="cpu")
    assert not m.spans_processes and m.local_time == list(range(8))
    assert [m.rank_of(t) for t in range(8)] == [0] * 8 and m.is_local(7)
    assert not distributed.is_initialized() and distributed.world_size() == 1


# ------------------------------------------------------------------ NOAA

@pytest.fixture(scope="module")
def noaa_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("noaa")
    iq, _ = synthesize(n_lines=12, snr_db=20)
    np.save(tmp / "iq.npy", iq)
    return iq, _run_workers(tmp, "noaa")


def test_two_process_full_noaa_decode(noaa_run):
    """The counterpart of the JAX two-process NOAA test: rank 0 against the
    port's unsharded decode, its crude syncs against JAX's unsharded
    decoder, both ranks the same result."""
    iq, ranks = noaa_run
    ref = NoaaDecoder(ArraySource(iq, FS), 30000, device="cpu")
    rimg = ref.get_image()
    rsa, rsb = ref.get_crude_sync()
    r0 = ranks[0]
    assert int(r0["useful"]) == 1 == ref.useful
    assert np.array_equal(r0["sync_a"], rsa) and np.array_equal(r0["sync_b"], rsb)
    assert r0["image"].shape == rimg.shape
    assert float(np.mean(r0["image"] == rimg)) > 0.999
    assert np.max(np.abs(r0["image"].astype(int) - rimg.astype(int))) <= 1
    acc = ref.get_accurate_sync()
    for key, col in (("acc_a", 0), ("acc_b", 4)):
        assert len(r0[key]) == len(acc[col]) > 0
        assert np.max(np.abs(r0[key] - np.asarray(acc[col]))) <= 1     # D12
    jdec = JNoaaDecoder(JArraySource(iq, FS), 30000)
    jsa, jsb = jdec.get_crude_sync()
    assert np.array_equal(r0["sync_a"], np.asarray(jsa))
    assert np.array_equal(r0["sync_b"], np.asarray(jsb))
    for key in ("image", "sync_a", "sync_b", "acc_a", "acc_b"):
        assert np.array_equal(ranks[1][key], r0[key]), key
