"""A Python model of the index arithmetic of the DDC+FM tile that K1 and K4
share (`directdemod_tpu_torch/csrc/ddc_fm_tile.cuh`), checked on the CPU.

The tile stages a block's span of samples into shared memory, skewed for
even J (span sample s at s + s/J, a zeroed pad after every J samples), the
taps in the same skew with a zero tap at each pad, and runs each thread's
tap loop over the positions of its window, pass by pass. The kernel's bits
rest on each output reading exactly its K (tap, sample) pairs in tap order,
with only zero taps on zeroed pads between them. `tile_plan` mirrors the
launch's choice of layout, threads a block and pass length; `window_reads`
mirrors the kernel's staging and loop bounds (the 32-bit multiply-shift
that stands for i / J included) and lists what each thread reads. Change
both with the kernel; `tests/test_torch_cuda.py` holds `tile_plan` to the
kernel's own plan on the card."""
import numpy as np
import pytest

T_MAX, T_MIN, CONV = 128, 32, 8
H100_SMEM_OPTIN = 232_448        # bytes a block may opt in to on an H100


def positions(n, j, skew):
    """Staged positions of n >= 1 span samples."""
    return n + (n - 1) // j if skew else n


def tile_plan(c, k, j, out_len, limit=H100_SMEM_OPTIN):
    """(T, S, skew, L, shared bytes, passes) as the launch picks them; a
    tile holds T - 1 new outputs."""
    words = limit // 8
    for skew in ((1, 0) if j % 2 == 0 and k < (1 << 16) else (0,)):
        el = k + (k - 1) // j if skew else k
        t = T_MAX
        while t > T_MIN and c * (el + t) + positions((t - 1) * j + k, j, skew) > words:
            t //= 2
        room = words - c * (el + t)
        assert room >= 1
        span = (t - 1) * j + k
        s = span
        if positions(span, j, skew) > room:
            s = (room + 1) // (j + 1) * j if skew else room
            if s < 1:
                continue
        return t, s, skew, el, 8 * (c * (el + t) + positions(s, j, skew)), -(-span // s)
    raise AssertionError("no plan")


def pos(i, magic):
    """The kernel's i + __umulhi(i, magic), for 0 <= i < 2^16."""
    i = np.asarray(i, np.int64)
    assert i.min(initial=0) >= 0 and i.max(initial=0) < (1 << 16)
    return i + ((i * magic) >> 32)


def window_reads(k, j, out_len, t, s, skew, el):
    """For every output m, the (tap, sample) pairs its thread reads, in
    loop order, over the passes of its tile of t - 1 new outputs (t
    threads); a tap of -1 is a pad's zero tap and a sample of -1 a zeroed
    pad. Thread 0's recomputed c[m-1] is read too (under the key ('prev',
    m))."""
    magic = (2 ** 32 // j + 1) if skew else 0
    p = np.arange(el)
    r = p // (j + 1) if skew else np.zeros_like(p)
    pad = (p - r * (j + 1) == j) if skew else np.zeros(el, bool)
    w_map = np.where(pad, -1, p - r)
    reads = {}
    for b in range(-(-out_len // (t - 1))):
        b0 = b * (t - 1)
        m_first = max(b0 - 1, 0)
        m_end = min(out_len, b0 + t - 1)
        s0, ns = m_first * j, (m_end - 1 - m_first) * j + k
        xs = np.full(positions(s, j, skew) + j + 1, -2, np.int64)   # -2: never written
        if skew:
            rows = np.arange((s - 1) // j)
            xs[rows * (j + 1) + j] = -1
        for lo in range(0, ns, s):
            ln = min(ns - lo, s)
            xs[pos(np.arange(ln), magic)] = s0 + lo + np.arange(ln)
            for tid in range(t):
                m = b0 - 1 + tid
                if not (0 <= m < m_end):
                    continue
                base = m * j - s0
                a, e = max(lo - base, 0), min(lo + ln - base, k)
                if a >= e:
                    continue
                pa, pe = int(pos(a, magic)), int(pos(e - 1, magic)) + 1
                xoff = (base - lo) // j * (j + 1) if skew else base - lo
                if skew:
                    assert (base - lo) % j == 0
                idx = xoff + np.arange(pa, pe)
                assert idx.min() >= 0
                key = m if tid > 0 or b == 0 else ("prev", m)
                reads.setdefault(key, []).append(np.stack([w_map[pa:pe], xs[idx]], 1))
    return {key: np.concatenate(v) for key, v in reads.items()}


def _check_reads(k, j, out_len, plan):
    t, s, skew, el = plan[:4]
    reads = window_reads(k, j, out_len, t, s, skew, el)
    assert sorted(key for key in reads if not isinstance(key, tuple)) == list(range(out_len))
    for key, rd in reads.items():
        m = key[1] if isinstance(key, tuple) else key
        taps, samples = rd[:, 0], rd[:, 1]
        real = taps >= 0
        assert np.array_equal(taps[real], np.arange(k)), key          # tap order
        assert np.array_equal(samples[real], m * j + np.arange(k)), key
        assert np.all(samples[~real] == -1), key                       # zeroed pads
        if skew:       # a pass that ends at a row's end skips that row's pad
            n_pads = np.sum(~real)
            assert n_pads == (k - 1) // j if plan[5] == 1 else n_pads <= (k - 1) // j, key
        else:
            assert real.all(), key


@pytest.mark.parametrize("j", [33, 34, 68, 92, 409, 1024])
@pytest.mark.parametrize("channels", [1, 3, 5])
def test_plan_of_the_main_strides(j, channels):
    """Skewed exactly for even J; a tile's whole span staged at once up to
    J = 409 (T = 128 to J = 92, 64 at J = 409), in passes of whole rows
    above J ~935; within the H100's shared memory."""
    t, s, skew, el, smem, passes = tile_plan(channels, 151, j, 588_000)
    assert skew == (j % 2 == 0) and el == (151 + 150 // j if skew else 151)
    assert smem <= H100_SMEM_OPTIN and T_MIN <= t <= T_MAX
    if j <= 92:
        assert t == T_MAX
    if j <= 409:
        assert passes == 1 and s == (t - 1) * j + 151
    else:
        assert passes > 1 and t == T_MIN and s % j == 0


@pytest.mark.parametrize("j,out_len", [(33, 300), (34, 300), (34, 1), (34, 127),
                                       (68, 129), (92, 260), (409, 40), (1024, 40)])
def test_each_window_reads_its_taps_in_order(j, out_len):
    """At the H100's plan: every output reads taps 0..K-1 on samples
    m*J .. m*J+K-1 in order, and only zeroed pads in between."""
    _check_reads(151, j, out_len, tile_plan(1, 151, j, out_len))


@pytest.mark.parametrize("j,k,extra", [(34, 151, 600), (34, 151, 1100), (68, 151, 1000),
                                       (92, 151, 700), (33, 151, 600), (4, 37, 50),
                                       (2, 7, 9), (35, 151, 600)])
def test_passes_keep_the_pads_aligned(j, k, extra):
    """With too little shared memory for a block's span, the span goes in
    passes (of whole rows when skewed) and every window still reads its
    taps in order."""
    el = k + (k - 1) // j if j % 2 == 0 else k
    limit = 8 * (el + T_MIN + extra)
    plan = tile_plan(1, k, j, 200, limit)
    assert plan[5] > 1 and plan[4] <= limit
    if plan[2]:
        assert plan[1] % j == 0
    _check_reads(k, j, 200, plan)


def test_no_skew_when_a_row_does_not_fit():
    """A pass that cannot hold J + 1 positions stages packed."""
    plan = tile_plan(1, 151, 2000, 10, 8 * (151 + 150 // 2000 + T_MIN + 1500))
    assert plan[2] == 0 and plan[1] == 1500
    _check_reads(151, 2000, 10, plan)


@pytest.mark.parametrize("j", [2, 34, 68, 92, 1024, 40_000, 65_536, 2 ** 20])
def test_multiply_shift_divides(j):
    """__umulhi(i, 2^32 // J + 1) == i // J for every i < 2^16."""
    i = np.arange(1 << 16, dtype=np.int64)
    assert np.array_equal((i * (2 ** 32 // j + 1)) >> 32, i // j)


@pytest.mark.parametrize("j,t,ln,ph", [(34, 128, 4469, 0), (34, 128, 4469, 1), (92, 128, 11835, 1),
                                       (409, 64, 25918, 0), (33, 128, 4342, 1), (34, 32, 1, 1),
                                       (34, 32, 2, 0), (1024, 32, 27648, 1), (7, 32, 300, 1)])
def test_k1_converts_its_bytes_in_place_safely(j, t, ln, ph):
    """K1 copies a pass's (I, Q) byte pairs into the tail of the buffer and
    converts them in place in ascending chunks of CONV*T samples (read,
    meet, write): no chunk's float2s land on bytes a later chunk has yet to
    read, and every sample lands at its position."""
    skew = j % 2 == 0
    magic = (2 ** 32 // j + 1) if skew else 0
    cap = positions(ln, j, skew) + 3               # a buffer may hold more than the pass
    np_ = (ln + ph + 1) // 2
    owner = np.full(8 * cap, -1, np.int64)         # which sample's byte, or -1
    start = 8 * cap - 4 * np_ + 2 * ph             # sample i's bytes at start + 2i
    assert start - 2 * ph >= 0 and (start - 2 * ph) % 4 == 0
    for i in range(ln):
        owner[start + 2 * i: start + 2 * i + 2] = i
    done = np.zeros(ln, bool)
    for i0 in range(0, ln, CONV * t):
        chunk = np.arange(i0, min(ln, i0 + CONV * t))
        for i in chunk:                            # reads: the bytes are still sample i's
            assert np.all(owner[start + 2 * i: start + 2 * i + 2] == i), (i0, i)
        done[chunk] = True
        for i in chunk:                            # writes: never on an unread sample's bytes
            at = 8 * int(pos(i, magic))
            hit = owner[at: at + 8]
            assert not np.any((hit >= 0) & ~done[np.maximum(hit, 0)]), (i0, i)
            owner[at: at + 8] = -2
    assert done.all()
