"""APT image-line assembly and radiometric calibration.

Port of `directdemod_tpu/models/apt.py:33-576`: sync filling, the image
stage's device work (zero-phase bandpass, blocked Hilbert envelope, the
contrast probe, the telemetry-strip medians, and the per-line Fourier
resample + pixel medians, batched by line length), then the host-side
calibration-wedge walk and uint8 quantization. The host code (`fill_syncs`,
`_Calib`, `_calibration_walk`) is a copy of the reference's NumPy code.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import constants as K
from ..ops import am as am_ops
from ..ops import resample as rs
from .stages import span


def median(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Median along `dim`, the mean of the two middle values for an even
    count, computed as (lo + hi) * 0.5 like `jnp.median` (quantile with the
    'midpoint' rule). `torch.median` returns the lower middle value, and
    `torch.quantile` refuses inputs over 2^24 elements."""
    n = x.shape[dim]
    srt = torch.sort(x, dim=dim).values
    lo = srt.narrow(dim, (n - 1) // 2, 1)
    hi = srt.narrow(dim, n // 2, 1)
    return ((lo + hi) * 0.5).squeeze(dim)


# ------------------------------------------------------------------ sync filling

def fill_syncs(csync, max_len) -> list:
    """Filter outlier syncs and synthesize missed ones (ref
    decode_noaa.py:467-508): keep pairs spaced within 200 samples of the
    modal spacing, then extend backward from the first valid sync and
    forward from each anchor. Degenerate inputs (fewer than two syncs, or a
    modal spacing within the wiggle) pass through sorted."""
    wiggle = 200
    csync = list(csync)
    if len(csync) < 2:
        return sorted(float(c) for c in csync)
    diffs = np.diff(csync)
    vals, counts = np.unique(diffs, return_counts=True)
    mode = vals[np.argmax(counts)]
    if mode <= wiggle:
        return sorted(float(c) for c in csync)

    valid: list = []
    for i in range(len(csync) - 1):
        if abs(csync[i + 1] - csync[i] - mode) < wiggle:
            if csync[i] not in valid:
                valid.append(csync[i])
            if csync[i + 1] not in valid:
                valid.append(csync[i + 1])
    corrected = valid[:]

    c = valid[0] - mode
    while c > wiggle:
        corrected.append(c)
        c -= mode

    anchor, c = 0, mode
    while valid[anchor] + c < max_len:
        nxt_exists = (anchor + 1) < len(valid)
        if nxt_exists and (abs(valid[anchor + 1] - c - valid[anchor]) < wiggle
                           or c + valid[anchor] > valid[anchor + 1]):
            anchor += 1
            c = mode
        else:
            corrected.append(valid[anchor] + c)
            c += mode
    return list(np.sort(corrected))


# ------------------------------------------------------------------ device stage

_SYNC_BITS = len(K.NOAA_SYNCA)          # 40: rows consumed by calibration


def _gather(env: torch.Tensor, starts, length: int) -> torch.Tensor:
    """(len(starts), length) rows env[s : s + length] (int64 starts)."""
    idx = torch.as_tensor(np.asarray(starts, dtype=np.int64), device=env.device)
    return env.unfold(0, length, 1)[idx]


def image_stage(audio: torch.Tensor, bp, am_block: int, strip_len: int,
                num_pixels: int, unit: int, spans_a: list, spans_b: list,
                env: torch.Tensor | None = None):
    """The image stage's device work (ref decode_noaa.py:274-373): bandpass
    + blocked envelope, the contrast probe, each line's pre-sync strip
    median, and per line-length group the resample to a multiple of `unit`
    pixels with the per-pixel median and the sync-train head. Returns host
    (probe, strips_a, strips_b, mats_a, mats_b); mats map a line to
    (median_row (unit,), head (_SYNC_BITS, k)). `env`: the band-passed
    envelope when it is computed already (the mesh path). The group loop
    is the range `noaa.image.lines.groups`."""
    if env is None:
        env = am_ops.envelope_blocked(bp.zero_phase(audio.float()), am_block)
    kk = env.shape[0] // num_pixels
    probe = median(env[: kk * num_pixels].reshape(num_pixels, kk)).cpu().numpy()

    def strips(spans):
        out = np.zeros(len(spans))
        full = [(i, s) for i, (s, _) in enumerate(spans) if s >= strip_len]
        if full:
            med = median(_gather(env, [s - strip_len for _, s in full],
                                 strip_len)).cpu().numpy()
            for (i, _), m in zip(full, med):
                out[i] = float(m)
        for i, (s, _) in enumerate(spans):
            if 0 < s < strip_len:
                out[i] = float(median(env[:s]))
        return out

    merged = list(spans_a) + list(spans_b)
    groups: dict[int, list] = {}
    for li, (s, e) in enumerate(merged):
        # duplicate or out-of-order syncs give empty or reversed spans:
        # zero-length lines instead of a negative resample size
        groups.setdefault(max(e - s, 0), []).append(li)
    mats: dict[int, tuple] = {}
    with span("noaa.image.lines.groups"):
        for ln, members in groups.items():
            k = ln // unit
            if k == 0:
                for li in members:
                    mats[li] = (np.zeros(0), np.zeros((_SYNC_BITS, 0)))
                continue
            rows = _gather(env, [merged[li][0] for li in members], ln)
            m = rs.fft_resample(rows, k * unit).reshape(len(members), unit, k)
            med = median(m).cpu().numpy()
            head = m[:, :_SYNC_BITS, :].cpu().numpy()
            for row, li in enumerate(members):
                mats[li] = (med[row], head[row])
    na = len(spans_a)
    return (probe, strips(spans_a), strips(spans_b),
            {i: mats[i] for i in range(na)},
            {i: mats[na + i] for i in range(len(spans_b))})


# ------------------------------------------------------------------ calibration

@dataclass
class _Calib:
    """Calibration-wedge state machine (ref decode_noaa.py:315-425)."""
    low: float
    high: float
    fifo_len: int = K.NOAA_COLORCORRECT_FIFOLEN
    low_fifo: list = field(default_factory=list)
    high_fifo: list = field(default_factory=list)
    corr_pix: list = field(default_factory=list)
    corr_sig: list = field(default_factory=list)
    corr_sig2: list = field(default_factory=list)
    chid1: list = field(default_factory=list)
    chid2: list = field(default_factory=list)
    last_pix: float | None = None
    last_sig: float | None = None
    state: int = 0
    wedge_pix: list = field(default_factory=list)
    wedge_sig: list = field(default_factory=list)
    slope: float | None = None
    intercept: float | None = None
    ch_id_a: int | None = None
    ch_id_b: int | None = None

    def update_from_sync_train(self, line_matrix: np.ndarray) -> None:
        """Re-estimate low/high from the known sync-train bits of a detected
        (not synthesized) line (ref decode_noaa.py:357-369)."""
        bits = np.asarray(K.NOAA_SYNCA)
        lows = np.asarray(line_matrix)[bits == 0].ravel()
        highs = np.asarray(line_matrix)[bits == 1].ravel()
        self.low_fifo = np.concatenate(
            [np.asarray(self.low_fifo), lows])[-self.fifo_len:]
        self.high_fifo = np.concatenate(
            [np.asarray(self.high_fifo), highs])[-self.fifo_len:]
        v11 = float(np.median(self.low_fifo))
        v244 = float(np.median(self.high_fifo))
        span = (v244 - v11) / (244.0 - 11.0)
        self.low = v11 - span * (11.0 - 0.0)
        self.high = v11 - span * (11.0 - 255.0)

    def step_wedge(self, strip_a: float, strip_b: float) -> None:
        """One line of the wedge detector (ref decode_noaa.py:371-425).
        strip_a/strip_b are the pre-sync telemetry-strip medians."""
        self.corr_pix.append(255.0 * (strip_a - self.low) / (self.high - self.low))
        self.corr_pix = self.corr_pix[-3:]
        out_pix = float(np.median(self.corr_pix))
        self.corr_sig.append(strip_a)
        self.corr_sig = self.corr_sig[-3:]
        out_sig = float(np.median(self.corr_sig))
        self.corr_sig2.append(strip_b)
        self.corr_sig2 = self.corr_sig2[-3:]
        out_sig2 = float(np.median(self.corr_sig2))

        self.chid1.append(out_sig2)
        self.chid1 = self.chid1[-100:]
        self.chid2.append(out_sig)
        self.chid2 = self.chid2[-100:]

        if self.last_pix is None or abs(out_pix - self.last_pix) > 255.0 / 16:
            if self.state == 0 and self.last_sig is not None:
                self.wedge_pix = [self.last_pix, out_pix]
                self.wedge_sig = [self.last_sig, out_sig]
                self.state = 1
            elif 1 <= self.state <= 6:
                if out_pix - self.wedge_pix[-1] > 2 * 255.0 / (8 * 3):
                    self.wedge_pix.append(out_pix)
                    self.wedge_sig.append(out_sig)
                    self.state += 1
                else:
                    self.state = 0
            elif self.state == 7:
                if self.wedge_pix[-1] - out_pix > 2 * 255.0 / 3:
                    self.wedge_sig = [out_sig] + self.wedge_sig
                    targets = np.arange(9) * 255.0 / 8
                    self.slope, self.intercept = _linregress(
                        np.asarray(self.wedge_sig), targets)
                    if len(self.chid1) > 1 + 64 + 8:
                        self.ch_id_a = int(np.round(
                            (self.slope * np.median(self.chid1[-1 - 64 - 8:-1 - 64])
                             + self.intercept) / (255.0 / 8)))
                        self.ch_id_b = int(np.round(
                            (self.slope * np.median(self.chid2[-1 - 64 - 8:-1 - 64])
                             + self.intercept) / (255.0 / 8)))
                    self.chid1, self.chid2 = [], []
                self.state = 0
        self.last_pix = out_pix
        self.last_sig = out_sig


def _linregress(x: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Least-squares slope/intercept (the subset of scipy.stats.linregress
    used at ref decode_noaa.py:413)."""
    mx, my = np.mean(x), np.mean(y)
    dx = x - mx
    slope = float(np.dot(dx, y - my) / np.dot(dx, dx))
    return slope, float(my - slope * mx)


def _quantize(line: np.ndarray, scale: float, offset: float) -> np.ndarray:
    q = np.round(line * scale + offset)
    return np.clip(q, 0, 255).astype(np.uint8)


# ------------------------------------------------------------------ assembly

def assemble_image(audio: torch.Tensor, rate: int, csync_a: list, csync_b: list,
                   ucsync: np.ndarray, bp, am_block: int,
                   env: torch.Tensor | None = None
                   ) -> tuple[np.ndarray, int | None, int | None]:
    """Build the calibrated APT image from the FM audio on its device and
    the filled syncs (ref decode_noaa.py:305-461), or from its band-passed
    envelope `env` when that is given. Returns (image, channel_id_a,
    channel_id_b). The device work and its copies are the span
    `noaa.image.lines`, the host walk `noaa.image.calibration`."""
    num_pixels = int(0.5 / K.NOAA_T)           # 2080 px per full line
    half = int(num_pixels * 0.5)               # 1040 per channel
    n_am = int(audio.shape[0])

    n_lines = len(csync_a)
    spans_a, spans_b, keep = [], [], []
    for i in range(n_lines):
        sa, sb = int(csync_a[i]), int(csync_b[i])
        ea = sb
        eb = sb + int(0.25 * rate)
        if i + 1 < n_lines:
            eb = int(csync_a[i + 1])
        if eb > n_am or ea > n_am or sa < 0 or sb < 0:
            continue
        keep.append(i)
        spans_a.append((sa, ea))
        spans_b.append((sb, eb))

    strip_len = int(len(K.NOAA_SYNCA) * K.NOAA_T * rate)
    with span("noaa.image.lines"):
        probe, strips_a, strips_b, mats_a, mats_b = image_stage(
            audio, bp, am_block, strip_len, num_pixels, half, spans_a, spans_b,
            env)
    with span("noaa.image.calibration"):
        return _calibration_walk(probe, mats_a, mats_b, strips_a, strips_b,
                                 csync_a, ucsync, keep, num_pixels)


def _calibration_walk(probe, mats_a, mats_b, strips_a, strips_b,
                      csync_a, ucsync, keep, num_pixels
                      ) -> tuple[np.ndarray, int | None, int | None]:
    """The host-side calibration/quantization walk over per-line reductions
    (ref decode_noaa.py:315-461): O(lines), a few hundred scalars each."""
    low, high = np.percentile(probe, (0.5, 99.5))
    calib = _Calib(low=float(low), high=float(high))

    image: list = []
    backup: list = []
    buffered: list = []
    ucset = set(float(u) for u in ucsync)

    for li, i in enumerate(keep):
        (med_a, head_a), (med_b, _) = mats_a[li], mats_b[li]

        if float(csync_a[i]) in ucset and head_a.shape[1] > 0:
            calib.update_from_sync_train(head_a)

        calib.step_wedge(float(strips_a[li]), float(strips_b[li]))

        line = np.concatenate([med_a, med_b])

        if calib.slope is None or calib.intercept is None:
            buffered.append(line.copy())
            backup.append(_quantize(line, 255.0 / (calib.high - calib.low),
                                    -255.0 * calib.low / (calib.high - calib.low)))
        else:
            if buffered:
                for b in buffered:
                    image.append(_quantize(b, calib.slope, calib.intercept))
                buffered = []
            image.append(_quantize(line, calib.slope, calib.intercept))

    if not image:
        image = backup                         # ref decode_noaa.py:454-456

    lens = [len(r) for r in image]
    if not lens:
        return np.zeros((0, num_pixels), dtype=np.uint8), None, None
    accepted = max(set(lens), key=lens.count)
    img = np.asarray([r for r in image if len(r) == accepted])
    return img, calib.ch_id_a, calib.ch_id_b
