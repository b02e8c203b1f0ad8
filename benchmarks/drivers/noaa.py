"""Driver of the `noaa_apt` configuration: NOAA APT passes decoded whole.

The pass is synthesized on the card and held there as bytes
(`DeviceRawSource`); each decode is a fresh `NoaaDecoder` running its
public calls `useful`, `get_crude_sync`, `get_image` and
`get_accurate_sync`, each marked as a `noaa.<call>` range for the trace.

The check holds every decode's crude syncs to the reference's own
(`crude_sync_deficit`): a crude sync is the argmax of a float32
correlation, and where the peak lies between two samples the port may take
either, so a decode's sync counts as the reference's where the reference's
own correlation at it lies within the limit of its best. The image and the
accurate syncs are then held to the reference's made at those syncs, which
are the reference's own up to such ties. The reference is
`benchmarks/reference/apt.py`, run over the same bytes.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks import counts
from benchmarks.harness import finite_or
from benchmarks.reference import apt as ref
from benchmarks.synth import apt as synth

NUMBERS = ("crude_sync_deficit", "image_share", "accurate_pos_gap",
           "accurate_quality_gap")


def setup(cfg, traffic, seed, device, workdir):
    if traffic["source"] != "card":
        raise ValueError(f"source {traffic['source']!r}: card")
    raw, _ = synth.pass_bytes(int(traffic["lines"]), cfg, traffic["noise"],
                              device, seed)
    n = raw.shape[0] // 2
    fs = int(cfg["sample_rate"])
    J = fs // int(cfg["fm_bandwidth_hz"])
    # one K1 launch over the whole capture
    least = counts.least_seconds(*counts.k1_launch_raw(n, J, int(cfg["frontend_taps"])))
    return {"cfg": cfg, "traffic": traffic, "device": device, "n": n,
            "raw": raw, "k1_least_s": least}


def _launches() -> dict:
    from directdemod_tpu_torch.ops import ddc
    return {"K1/K4": ddc.LAUNCHES}


def decode_once(st, sample):
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.noaa import NoaaDecoder
    from directdemod_tpu_torch.ops import ddc
    ddc.LAUNCHES = 0
    cfg = st["cfg"]
    span = torch.profiler.record_function
    dec = NoaaDecoder(DeviceRawSource(st["raw"], int(cfg["sample_rate"])),
                      cfg["offset_hz"], device=st["device"])
    with span("noaa.useful"):
        useful = dec.useful
    with span("noaa.get_crude_sync"):
        sa, sb = dec.get_crude_sync()
    with span("noaa.get_image"):
        img = dec.get_image()
    with span("noaa.get_accurate_sync"):
        acc = dec.get_accurate_sync(use_norm_correlate=True)
    if st["device"].type == "cuda":
        torch.cuda.synchronize()
    return {"useful": useful, "crude": (np.asarray(sa), np.asarray(sb)),
            "image": img, "accurate": acc, "stage_seconds": dec.stage_seconds,
            "launches": _launches(), "least_s": {"ddc_fm_u8_kernel": st["k1_least_s"]}}


def capture_seconds(st):
    return st["n"] / float(st["cfg"]["sample_rate"])


def release(st):
    """The program's objects are the records' products only; nothing else
    to drop."""


def crude_sync_deficit(prog_crude, fr) -> float:
    """By how much the reference's own correlation at a decode's crude sync
    lies below its best, as a share of the best: the largest over the
    syncs, paired in order with the reference's (inf if the counts differ
    or a sync lies outside the correlation)."""
    worst = 0.0
    for got, want, cor in zip(prog_crude, (fr["sync_a"], fr["sync_b"]),
                              (fr["cor_a"], fr["cor_b"])):
        if len(got) != len(want) or len(want) == 0:
            return float("inf")
        p = np.asarray(got, np.int64) + fr["half"]
        r = np.asarray(want, np.int64) + fr["half"]
        if p.min() < 0 or p.max() >= cor.shape[0]:
            return float("inf")
        best = cor[torch.as_tensor(r, device=cor.device)].double().cpu()
        at = cor[torch.as_tensor(p, device=cor.device)].double().cpu()
        worst = max(worst, float(((best - at) / best.abs()).max()))
    return max(worst, 0.0)


def compare(prog_img, prog_acc, prog_crude, fr, want) -> dict:
    """The check's numbers for one decode's products: its crude syncs
    against the reference's front end `fr` (of `reference.front`), its
    image and accurate syncs against the reference's products `want` (of
    `reference.products`)."""
    out = {"crude_sync_deficit": crude_sync_deficit(prog_crude, fr)}
    wi = want["image"]
    if prog_img is None or prog_img.shape != wi.shape:
        out["image_share"] = 1.0
    else:
        out["image_share"] = float(np.mean(prog_img != wi))
    pos, qual = 0.0, 0.0
    for k in (0, 4):
        pa, ra = prog_acc[k] if prog_acc else [], want["accurate"][k]
        if len(pa) != len(ra) or not ra:
            pos, qual = float("inf"), float("inf")
            break
        pos = max(pos, float(np.max(np.abs(np.asarray(pa, np.float64)
                                           - np.asarray(ra, np.float64)))))
        pq = np.asarray(prog_acc[k + 2], np.float64)
        rq = np.asarray(want["accurate"][k + 2], np.float64)
        qual = max(qual, float(np.max(np.abs(pq - rq))))
    out["accurate_pos_gap"] = pos
    out["accurate_quality_gap"] = qual
    return out


def _front(st) -> dict:
    """The reference's front end, made once a run."""
    if "front" not in st:
        st["front"] = ref.front(st["raw"], st["cfg"], "fp64")
        st["products"] = {}
    return st["front"]


def reference(st, crude) -> tuple[dict, dict]:
    """The reference's front end and its products at the crude syncs
    `crude` where they are the reference's own up to ties (the deficit
    within its limit), else at the reference's own (made once for each set
    of crude syncs met)."""
    fr = _front(st)
    if crude_sync_deficit(crude, fr) > st["cfg"]["limits"]["crude_sync_deficit"]:
        crude = (fr["sync_a"], fr["sync_b"])
    key = tuple(tuple(int(v) for v in c) for c in crude)
    if key not in st["products"]:
        st["products"][key] = ref.products(st["raw"], st["cfg"], fr, *crude)
    return fr, st["products"][key]


def control(st) -> dict:
    """The control's numbers: the reference in TF32 in the program's place
    (its own crude syncs, image and accurate syncs), against the reference."""
    ctl = ref.decode(st["raw"], st["cfg"], "tf32")
    crude = (ctl["sync_a"], ctl["sync_b"])
    fr, want = reference(st, crude)
    return compare(ctl["image"], ctl["accurate"], crude, fr, want)


def planted(st) -> dict:
    """Readings of faults planted in the reference put in the program's
    place: every crude sync one sample late."""
    fr = _front(st)
    late = (np.asarray(fr["sync_a"]) + 1, np.asarray(fr["sync_b"]) + 1)
    return {"crude_sync_deficit.one_late": crude_sync_deficit(late, fr)}


def check(st, records):
    lim = st["cfg"]["limits"]
    worst = {k: 0.0 for k in NUMBERS}
    failed = 0
    for rec in records:
        fr, want = reference(st, rec["crude"])
        nums = compare(rec["image"], rec["accurate"], rec["crude"], fr, want)
        failed += int(any(nums[k] > lim[k] for k in nums))
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
    locks = sorted({p["locks"] for p in st.get("products", {}).values()})
    print(f"reference wedge fits a decode: {locks}", flush=True)
    return [(k, finite_or(v, 1e9), lim[k]) for k, v in worst.items()], failed
