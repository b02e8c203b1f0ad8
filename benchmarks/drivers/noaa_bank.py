"""Driver of the `noaa_apt_3sat` configuration: three NOAA APT passes in one
capture, decoded whole by one bank.

The capture (`benchmarks/synth/apt_bank.py`) is synthesized on the card and
held there as bytes (`DeviceRawSource`); each decode is a fresh
`NoaaBankDecoder` at the configuration's channel offsets running every
channel's `useful`, crude syncs, image and accurate syncs, each call marked
as a `noaa_bank.<call>` range for the trace.

The check holds each channel to the plain reference of that channel alone
(`benchmarks/reference/apt_bank.py`, the single-channel chain at the
channel's offset over the same bytes) with `noaa_apt`'s comparison
(`drivers/noaa.py`: `crude_sync_deficit`, `compare`), each number the
worst over the channels; `channels_not_useful` counts the channels whose
usefulness test failed. A decode fails if any channel fails any limit.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmarks import counts
from benchmarks.drivers.noaa import NUMBERS, compare, crude_sync_deficit
from benchmarks.harness import finite_or
from benchmarks.reference import apt_bank as ref
from benchmarks.synth import apt_bank as synth


def _offsets(cfg) -> list:
    return [float(ch["offset_hz"]) for ch in cfg["channels"]]


def setup(cfg, traffic, seed, device, workdir):
    # a program without the bank decoder fails here, before the synthesis
    from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder  # noqa: F401
    if traffic["source"] != "card":
        raise ValueError(f"source {traffic['source']!r}: card")
    if int(traffic["channels"]) != len(cfg["channels"]):
        raise ValueError(f"{traffic['channels']} channels, the configuration "
                         f"has {len(cfg['channels'])}")
    raw, _ = synth.pass_bytes(int(traffic["lines"]), cfg, traffic["noise"],
                              device, seed)
    n = raw.shape[0] // 2
    J = int(cfg["sample_rate"]) // int(cfg["fm_bandwidth_hz"])
    # one K1 launch over the whole capture for all channels
    least = counts.least_seconds(*counts.ddc_launch(
        2 * n, len(cfg["channels"]), -(-n // J), int(cfg["frontend_taps"])))
    return {"cfg": cfg, "traffic": traffic, "device": device, "n": n,
            "raw": raw, "k1_least_s": least}


def decode_once(st, sample):
    from directdemod_tpu_torch.io.sources import DeviceRawSource
    from directdemod_tpu_torch.models.noaa_bank import NoaaBankDecoder
    from directdemod_tpu_torch.ops import ddc
    ddc.LAUNCHES = 0
    cfg = st["cfg"]
    span = torch.profiler.record_function
    bank = NoaaBankDecoder(DeviceRawSource(st["raw"], int(cfg["sample_rate"])),
                           _offsets(cfg), device=st["device"])
    with span("noaa_bank.useful"):
        useful = bank.useful
    with span("noaa_bank.get_crude_sync"):
        crude = [(np.asarray(a), np.asarray(b)) for a, b in bank.get_crude_sync()]
    with span("noaa_bank.get_image"):
        images = [ch.get_image() if ch.useful else None for ch in bank.channels]
    with span("noaa_bank.get_accurate_sync"):
        acc = [ch.get_accurate_sync(use_norm_correlate=True) if ch.useful else None
               for ch in bank.channels]
    if st["device"].type == "cuda":
        torch.cuda.synchronize()
    return {"useful": useful, "crude": crude, "images": images, "accurate": acc,
            "stage_seconds": bank.stage_seconds, "counters": dict(bank.counters),
            "launches": {"K1/K4": ddc.LAUNCHES},
            "least_s": {"ddc_fm_u8_kernel": st["k1_least_s"]}}


def capture_seconds(st):
    """The capture's seconds, not the channels': realtime_x is recordings
    decoded a wall second."""
    return st["n"] / float(st["cfg"]["sample_rate"])


def release(st):
    """The program's objects are the records' products only; nothing else
    to drop."""


def _front(st, c: int) -> dict:
    """The reference's front end of channel `c`, made once a run."""
    fronts = st.setdefault("front", {})
    if c not in fronts:
        fronts[c] = ref.front(st["raw"], st["cfg"], c, "fp64")
        st.setdefault("products", {})[c] = {}
    return fronts[c]


def reference(st, c: int, crude) -> tuple[dict, dict]:
    """Channel `c`'s reference front end and its products at the crude
    syncs `crude` where they are the reference's own up to ties (the
    deficit within its limit), else at the reference's own (made once for
    each set of crude syncs met)."""
    fr = _front(st, c)
    if crude_sync_deficit(crude, fr) > st["cfg"]["limits"]["crude_sync_deficit"]:
        crude = (fr["sync_a"], fr["sync_b"])
    key = tuple(tuple(int(v) for v in s) for s in crude)
    made = st["products"][c]
    if key not in made:
        made[key] = ref.products(st["raw"], st["cfg"], c, fr, *crude)
    return fr, made[key]


def numbers(st, useful, crude, images, accurate) -> dict:
    """The check's numbers for one decode's products, a list a channel:
    each of `noaa_apt`'s the worst over the channels, and the channels
    whose usefulness test failed."""
    worst = {k: 0.0 for k in NUMBERS}
    for c in range(len(st["cfg"]["channels"])):
        fr, want = reference(st, c, crude[c])
        for k, v in compare(images[c], accurate[c], crude[c], fr, want).items():
            worst[k] = max(worst[k], v)
    worst["channels_not_useful"] = float(sum(int(u != 1) for u in useful))
    return worst


def control(st) -> dict:
    """The control's numbers: the reference in TF32 in the program's place
    (each channel's own crude syncs, image and accurate syncs), against the
    reference."""
    ctl = [ref.decode(st["raw"], st["cfg"], c, "tf32")
           for c in range(len(st["cfg"]["channels"]))]
    return numbers(st, [d["useful"] for d in ctl],
                   [(d["sync_a"], d["sync_b"]) for d in ctl],
                   [d["image"] for d in ctl], [d["accurate"] for d in ctl])


def planted(st) -> dict:
    """Readings of faults planted in the reference put in the program's
    place: every crude sync of one channel one sample late; one channel
    (the second) decoded at its neighbour's (the first's) offset."""
    fr0, fr1 = _front(st, 0), _front(st, 1)
    late = (np.asarray(fr1["sync_a"]) + 1, np.asarray(fr1["sync_b"]) + 1)
    _, want0 = reference(st, 0, (fr0["sync_a"], fr0["sync_b"]))
    _, want1 = reference(st, 1, (fr1["sync_a"], fr1["sync_b"]))
    swapped = compare(want0["image"], want0["accurate"],
                      (fr0["sync_a"], fr0["sync_b"]), fr1, want1)
    return {"crude_sync_deficit.one_late": crude_sync_deficit(late, fr1),
            **{f"{k}.neighbour": v for k, v in swapped.items()}}


def check(st, records):
    lim = st["cfg"]["limits"]
    worst = {k: 0.0 for k in (*NUMBERS, "channels_not_useful")}
    failed = 0
    for rec in records:
        nums = numbers(st, rec["useful"], rec["crude"], rec["images"],
                       rec["accurate"])
        failed += int(any(nums[k] > lim[k] for k in nums))
        for k, v in nums.items():
            worst[k] = max(worst[k], v)
    locks = {c: sorted({p["locks"] for p in made.values()})
             for c, made in st.get("products", {}).items()}
    print(f"reference wedge fits a decode, by channel: {locks}", flush=True)
    return [(k, finite_or(v, 1e9), lim[k]) for k, v in worst.items()], failed
