"""`ops.peaks.group_peaks_dense`, the APT sync grouping on the device, held
to the host walk `ops.peaks.group_peaks` over `ops.peaks.candidates_above`,
row for row and element for element (both compare the same float32
values, so the result must be equal).

Rows: exact-tie plateaus, +/-0.0 under a negative threshold, ramps and
sawtooths longer than the window (long chains of window argmaxes), rows
with >= 90 % above the threshold and flat stretches (as the NOAA needle B
gives), sparse rows, a lone candidate at the last index, no candidate and
one; min_dist integer and fractional, below 1 and above the row's length;
two rows under their own thresholds; rows whose chains of argmaxes and of
group starts are as long as the bounds that fix the rounds allow; rows over
several blocks of the next-candidate scan with gaps longer than a block.

The `cuda` test groups a two-row input of 36.1 M samples a row at
min_dist = 0.45 x 60235 (the NOAA crude sync's) on the card, holds it to
the host walk and prints the card's time. The file imports no jax, so on
the card it runs alone:

    python -m pytest tests/test_torch_peaks_group.py --noconftest -q -s
"""
import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from directdemod_tpu_torch.ops import peaks  # noqa: E402

torch.set_num_threads(1)

N = 3000
DISTS = [0.5, 1, 3.5, 7, 27.3, 250.75, "beyond"]


def _walk(x: np.ndarray, thr: float, min_dist: float) -> np.ndarray:
    idx, vals = peaks.candidates_above(torch.from_numpy(x),
                                       torch.tensor(thr, dtype=torch.float32))
    return peaks.group_peaks(idx, vals, min_dist)


def _dense(x: np.ndarray, thr, min_dist: float) -> list:
    slots = peaks.group_peaks_dense(torch.from_numpy(x), thr, min_dist).numpy()
    return [row[row < x.shape[-1]] for row in slots.reshape(-1, slots.shape[-1])]


def _check(x: np.ndarray, thr: float, min_dist: float) -> np.ndarray:
    want = _walk(x, thr, min_dist)
    (got,) = _dense(x, thr, min_dist)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    return want


def _plateaus(rng, n):
    levels = rng.integers(0, 4, n // 8 + 1)
    return np.repeat(levels, 8)[:n].astype(np.float32), 0.5


def _signed_zeros(rng, n):
    vals = np.array([-0.0, 0.0, -1.0, -0.0, 0.0], np.float32)
    return rng.choice(vals, n), -0.5


def _ramp(rng, n):
    return np.arange(n, dtype=np.float32), -1.0


def _sawtooth(rng, n):
    return (np.arange(n) % 700).astype(np.float32), 10.0


def _falling_sawtooth(rng, n):
    return -(np.arange(n) % 700).astype(np.float32), -650.0


def _needle_b(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    for s in rng.integers(0, n - 200, 6):
        x[s:s + 200] = 0.75                 # flat stretches, all above
    x[::300] += 6.0
    return x, float(np.quantile(x, 0.08))


def _sparse(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    return x, float(np.quantile(x, 0.995))


def _last_index(rng, n):
    x = np.zeros(n, np.float32)
    x[[n // 3, n - 1]] = 1.0
    return x, 0.5


def _none(rng, n):
    return rng.standard_normal(n).astype(np.float32), 100.0


def _one(rng, n):
    x = np.full(n, -1.0, np.float32)
    x[int(rng.integers(0, n))] = 2.0
    return x, 0.0


ROWS = {f.__name__[1:]: f for f in (_plateaus, _signed_zeros, _ramp, _sawtooth,
                                    _falling_sawtooth, _needle_b, _sparse,
                                    _last_index, _none, _one)}


@pytest.mark.parametrize("min_dist", DISTS, ids=str)
@pytest.mark.parametrize("kind", list(ROWS))
def test_dense_grouping_equals_the_walk(kind, min_dist):
    rng = np.random.default_rng(len(kind) * 1009 + 17)
    x, thr = ROWS[kind](rng, N)
    d = 2 * N + 0.5 if min_dist == "beyond" else float(min_dist)
    want = _check(x, thr, d)
    if kind == "none":
        assert len(want) == 0
    elif kind == "one":
        assert len(want) == 1
    elif kind == "last_index" and d <= N // 3:
        assert want[-1] == N - 1
    if min_dist == "beyond" and kind != "none":
        assert len(want) == 1


@pytest.mark.parametrize("min_dist", [2, 27.3])
def test_two_rows_with_their_own_thresholds(min_dist):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, N)).astype(np.float32)
    x[1, ::97] += 4.0
    thr = torch.tensor([-1.0, 2.5])
    got = _dense(x, thr, min_dist)
    assert len(got) == 2
    for row in range(2):
        np.testing.assert_array_equal(got[row], _walk(x[row], float(thr[row]),
                                                      min_dist))
    # the threshold is each row's own: the second row keeps far fewer
    assert len(got[1]) < len(got[0])


@pytest.mark.parametrize("min_dist", [1.5, 2, 3.5, 7, 27.3, 100])
def test_argmax_chain_as_long_as_its_bound(min_dist):
    """Candidates at k T and k T + 1 alone, rising: each window's argmax is
    the next of them, so the chain from the first candidate makes two hops
    a T, the most the pointer jumping's rounds allow for."""
    t = int(np.ceil(min_dist))
    x = np.full(N, -1.0, np.float32)
    at = np.sort(np.concatenate([np.arange(0, N, t), np.arange(1, N, t)]))
    at = np.unique(at[at < N])
    x[at] = np.arange(1, len(at) + 1, dtype=np.float32)
    want = _check(x, 0.0, min_dist)
    assert len(want) == 1 and want[0] == at[-1]


@pytest.mark.parametrize("groups", [1, 2, 3, 4, 5, 8, 9, 16, 17, 33])
def test_group_chain_as_long_as_its_bound(groups):
    """Every sample a candidate and all equal: a group every T samples from
    0, as many as the doubling's rounds allow for (2^k + 1 groups need one
    round more than 2^k)."""
    t = 5
    x = np.zeros(groups * t, np.float32)
    want = _check(x, -1.0, 4.5)
    np.testing.assert_array_equal(want, np.arange(groups) * t)


@pytest.mark.parametrize("min_dist", [27.3, 5000, 20000.5])
def test_gaps_longer_than_a_scan_block(min_dist):
    """Rows over several blocks of the next-candidate scan, with candidate
    gaps longer than a block: the next group's start is found blocks
    away."""
    n = 5 * peaks._SCAN_BLOCK + 123
    rng = np.random.default_rng(9)
    x = np.full(n, -1.0, np.float32)
    at = np.array([7, 8, 9000, 9001, 9003, 15000, n - 2, n - 1])
    x[at] = rng.integers(1, 4, len(at)).astype(np.float32)
    x[3 * peaks._SCAN_BLOCK:3 * peaks._SCAN_BLOCK + 50] = 2.0
    want = _check(x, 0.0, min_dist)
    assert len(want) >= (3 if min_dist < 5000 else 1)


@pytest.mark.parametrize("seed", range(10))
def test_random_rows(seed):
    """60 rows a seed of random lengths, kinds, thresholds and distances."""
    rng = np.random.default_rng(seed)
    for trial in range(60):
        n = int(rng.integers(1, 400))
        x, thr = list(ROWS.values())[trial % len(ROWS)](rng, max(n, 201))
        x = x[:n]
        if trial % 3 == 0:
            thr = float(np.float32(np.quantile(x, rng.uniform(0.0, 1.0))))
        d = float(rng.choice([0.0, 0.5, 1, 2, 3.5, 7, 27.3, 100, 250.75, 5000]))
        _check(x, thr, d)


def test_other_dtypes_are_refused():
    with pytest.raises(ValueError):
        peaks.group_peaks_dense(torch.zeros(8, dtype=torch.float64), 0.0, 2.0)


@pytest.mark.cuda
def test_card_matches_the_walk_at_full_size():
    """Two rows of 36.1 M samples at the crude sync's min_dist: one with
    ~91 % above its threshold, flat stretches and plateaus (needle B), one
    sparse (needle A); equal to the host walk, the card's time printed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    n, min_dist, period = 36_100_000, 0.45 * 60235, 30_117
    gen = torch.Generator(device=dev).manual_seed(15)
    cor = torch.round(torch.rand(2, n, generator=gen, device=dev) * 1024) / 1024
    cor[0, 1_000_000:3_000_000] = 0.5
    cor[:, ::period] += 2.0
    thr = torch.tensor([0.09, 0.999], device=dev)
    peaks.group_peaks_dense(cor, thr, min_dist)            # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    reps = 5
    t0.record()
    for _ in range(reps):
        slots = peaks.group_peaks_dense(cor, thr, min_dist)
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / reps
    extra = torch.cuda.max_memory_allocated() - base
    got = [row[row < n] for row in slots.cpu().numpy()]
    host = cor.cpu()
    for row in range(2):
        h0 = time.perf_counter()
        idx, vals = peaks.candidates_above(host[row], thr[row].cpu())
        want = peaks.group_peaks(idx, vals, min_dist)
        walk_s = time.perf_counter() - h0
        np.testing.assert_array_equal(got[row], want)
        print(f"row {row}: {len(idx)} candidates, {len(want)} syncs, "
              f"host walk {walk_s:.3f} s")
    print(f"group_peaks_dense on {torch.cuda.get_device_name(0)}: "
          f"{ms:.3f} ms for 2 x {n} samples, {extra / 1e9:.3f} GB above its input")
