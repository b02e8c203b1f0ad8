"""Driver of the `funcube_bpsk` configuration: FUNcube-1 passes decoded
whole from bytes held on the card.

Each decode is a fresh `FuncubeDecoder(...).get_syncs()` over a
`DeviceRawSource`, marked as a `funcube.get_syncs` range for the trace: a
10-minute pass goes through its block loop (62 blocks: the front end, K3
with the scan state carried, host pass 2). K3's least time counts the
capture's symbols (its samples over the samples a symbol).

For the one decode the harness samples, the driver keeps one block of the
scan: it wraps the scan's public entry `ops.pll.symbol_scan(p, x, state,
sync, sync1) -> (state, Symbols)` for that decode alone, keeping the
block's filtered input, the state before it and its symbols; the
program's work is not changed. Every other decode runs the program as it
is.

The check compares every decode's syncs with the reference's syncs of the
planted frames after the first (the decoder reports the frames after the
first), and for the sampled decode the filtered block (`baseband_gap`) and
the scan's symbols over that block (`symbol_gap`) with
`benchmarks/reference/bpsk.py`; a decode that never calls the entry leaves
those two unread, which fails them.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from benchmarks import counts
from benchmarks.harness import finite_or
from benchmarks.reference import bpsk as ref
from benchmarks.reference.apt import Precision
from benchmarks.synth import bpsk as synth

KERNEL = "symbol_scan_kernel"


class _ScanRecorder:
    """Stands in for `pll.symbol_scan` during one decode: passes every call
    through and keeps the input, the state before and the symbols of call
    `keep_call` (of the last call, if the decode makes fewer)."""

    def __init__(self, scan, keep_call: int):
        self.orig = scan
        self.keep_call = keep_call
        self.calls = 0
        self.offset = 0
        self.kept = None

    def __call__(self, p, x, state, sync, sync1):
        keep = self.calls <= self.keep_call
        if keep:
            before = {n: t.clone() for n, t in state.items()}
        new, syms = self.orig(p, x, state, sync, sync1)
        if keep:
            self.kept = {"x": x, "state": before, "syms": syms,
                         "start": self.offset}
        self.calls += 1
        self.offset += int(x.shape[0])
        return new, syms


def setup(cfg, traffic, seed, device, workdir):
    fs = int(cfg["sample_rate"])
    raw, starts = synth.pass_bytes(
        float(traffic["seconds"]), fs, int(cfg["bit_rate"]), cfg["sync_bits"],
        float(traffic["first_frame_s"]), float(cfg["frame_spacing_s"]),
        float(cfg["amplitude"]), int(cfg["offset_hz"]) + int(cfg["carrier_error_hz"]),
        float(traffic["noise"]), int(traffic["clear_margin"]), device, seed)
    n = raw.shape[0] // 2
    blocks = -(-n // int(cfg["block_samples"]))
    rng = np.random.default_rng([seed, 0xB10C])
    symbols = n * float(cfg["symbol_rate"]) / fs
    return {"cfg": cfg, "traffic": traffic, "device": device, "raw": raw,
            "starts": starts, "n": n, "block": int(rng.integers(0, blocks)),
            "k3_least_s": counts.least_seconds(*counts.k3_symbols(symbols))}


def decode_once(st, sample):
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.funcube import FuncubeDecoder
    from directdemod_tpu_torch.ops import pll
    cfg = st["cfg"]
    pll.LAUNCHES = 0
    scan = pll.symbol_scan
    if sample:
        pll.symbol_scan = _ScanRecorder(scan, st["block"])
    try:
        dec = FuncubeDecoder(DeviceRawSource(st["raw"], int(cfg["sample_rate"])),
                             cfg["offset_hz"], device=st["device"])
        with torch.profiler.record_function("funcube.get_syncs"):
            syncs = dec.get_syncs()
        if st["device"].type == "cuda":
            torch.cuda.synchronize()
    finally:
        rec, pll.symbol_scan = pll.symbol_scan, scan
    out = {"syncs": list(syncs), "useful": dec.useful,
           "stage_seconds": dec.stage_seconds, "launches": {"K3": pll.LAUNCHES},
           "least_s": {KERNEL: st["k3_least_s"]}}
    if sample:
        out["heavy"] = rec.kept
    return out


def capture_seconds(st):
    return st["n"] / float(st["cfg"]["sample_rate"])


def release(st):
    """The program's objects are the records' products only; nothing else
    to drop."""


def baseband_gap(prog_x: torch.Tensor, want: torch.Tensor) -> float:
    """99.9th percentile of |program - reference| over the block, as a
    share of the reference's RMS."""
    if prog_x.shape[0] != want.shape[0]:
        return float("inf")
    d = (prog_x.to(want.device).to(torch.complex128) - want.to(torch.complex128)).abs()
    rms = float(want.to(torch.complex128).abs().pow(2).mean().sqrt())
    k = max(1, int(np.ceil(0.999 * d.shape[0])))
    return float(torch.kthvalue(d.float().cpu(), k).values) / rms


def symbol_gap(prog_a, prog_m, ref_a, ref_m) -> float:
    """Share of the reference's symbols whose A-sample index lies more than
    one sample from the program's, or whose minsync flag differs (a length
    difference counts whole). A one-sample step is rounding: the timing's
    ceil() flips where float32 and float64 land on either side of a whole
    sample, for 0.07-1.8 % of a block's symbols, by seed."""
    n = min(len(prog_a), len(ref_a))
    da = np.abs(np.asarray(prog_a[:n], np.int64) - np.asarray(ref_a[:n], np.int64))
    diff = np.count_nonzero((da > 1)
                            | (np.asarray(prog_m[:n]) != np.asarray(ref_m[:n])))
    return (diff + abs(len(prog_a) - len(ref_a))) / max(len(ref_a), 1)


def sync_gap(prog, want) -> float:
    """Largest distance between the program's syncs and the reference's,
    in order (inf if their counts differ)."""
    if len(prog) != len(want) or not want:
        return float("inf")
    return float(np.max(np.abs(np.asarray(prog, np.float64)
                               - np.asarray(want, np.float64))))


def _block_numbers(st, kept, precision) -> dict:
    """baseband_gap and symbol_gap of one kept scan call, the reference at
    `precision` in the program's place."""
    cfg, raw = st["cfg"], st["raw"]
    prec = Precision(precision)
    h = ref.lowpass_response(cfg)
    a = kept["start"]
    x = kept["x"]
    want = ref.filtered(raw, cfg, a, a + int(x.shape[0]), h, Precision("fp64"))
    mine = want if precision == "fp64" else \
        ref.filtered(raw, cfg, a, a + int(x.shape[0]), h, prec)
    f, i = (kept["state"][k][0].cpu().tolist() for k in ("f", "i"))
    ra, rm = ref.scan(mine.to(torch.complex128).cpu().numpy(), ref.ScanState(f, i),
                      cfg, precision)
    if precision == "fp64":
        syms = kept["syms"]
        bb = baseband_gap(x, want)
        pa, pm = syms.a_idx.cpu().tolist(), syms.minsync.cpu().tolist()
    else:
        bb = baseband_gap(mine, want)
        pa, pm = ref.scan(want.cpu().numpy(), ref.ScanState(f, i), cfg, "fp64")
    return {"baseband_gap": bb, "symbol_gap": symbol_gap(pa, pm, ra, rm)}


def reference_syncs(st, precision="fp64") -> list:
    key = "want_" + precision
    if key not in st:
        st[key] = ref.frame_syncs(st["raw"], st["cfg"], st["starts"][1:],
                                  Precision(precision))
    return st[key]


def control(st) -> dict:
    """The control's numbers: the reference at TF32 / bfloat16 in the
    program's place, against the reference, over the kept block and the
    frames."""
    kept = st["last_kept"]
    nums = _block_numbers(st, kept, "tf32")
    nums["sync_gap"] = sync_gap(reference_syncs(st, "tf32"), reference_syncs(st))
    return nums


def check(st, records):
    lim = st["cfg"]["limits"]
    want = reference_syncs(st)
    worst = {"sync_gap": 0.0}
    block = None
    failed = 0
    for r in records:
        g = sync_gap(r["syncs"], want)
        bad = g > lim["sync_gap"] or r["useful"] != 1
        worst["sync_gap"] = max(worst["sync_gap"], g)
        if "heavy" in r:
            if r["heavy"] is None:
                print("the decode never called ops.pll.symbol_scan: "
                      "no block of the scan to check", file=sys.stderr)
                block = {}
                bad = True
            else:
                st["last_kept"] = r["heavy"]
                block = _block_numbers(st, r["heavy"], "fp64")
                bad = bad or any(block[k] > lim[k] for k in block)
        failed += int(bad)
    numbers = [(k, finite_or(v if v is not None else float("inf"), 1e9), lim[k])
               for k, v in (("baseband_gap", (block or {}).get("baseband_gap")),
                            ("symbol_gap", (block or {}).get("symbol_gap")),
                            ("sync_gap", worst["sync_gap"]))]
    return numbers, failed
