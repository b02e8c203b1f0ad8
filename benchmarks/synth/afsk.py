"""Seeded ISS APRS pass as 8-bit IQ bytes, made on the device.

The frames are built on the host from the seed: AX.25 UI frames (AX.25
v2.2 addresses with SSID bytes, one digipeater field `RS0ISS*`, control
0x03, PID 0xF0, an APRS info field, the CRC-16-CCITT FCS), HDLC bit
stuffing, flags before and after, NRZI. Each transmission starts at a
sample of its own, so every frame has its own baud phase. After its last
flag the carrier stays on, unmodulated, for a tail drawn from
`tail_s` (the radio's release of its PTT); between transmissions the
carrier is off and the bytes hold noise only.

The modulation runs on the device in float64, chunk by chunk: Bell 202
AFSK (mark 1,200 Hz, space 2,200 Hz, the tone's phase continuous), FM of
`deviation_hz` by the tone, both phase integrals carried from chunk to
chunk; the ISS Doppler as an S-curve, -D u / sqrt(u^2 + tau^2) at u
seconds from the pass's middle, whose phase is its closed-form integral;
an amplitude rising from the horizons to closest approach; the channel
offset and the noise as `synth/bpsk.py::_to_bytes` adds them, quantized at
x + 127.5.
"""
from __future__ import annotations

import string
from dataclasses import dataclass

import numpy as np
import torch

from benchmarks.synth.bpsk import _to_bytes

FLAG = (0, 1, 1, 1, 1, 1, 1, 0)
PRINTABLE = np.frombuffer((string.ascii_letters + string.digits
                           + " .,:;!?-/+*#()").encode(), np.uint8)


@dataclass
class Frame:
    """One planted frame: its AX.25 fields as the decoder renders them
    (each address as seven 7-bit characters, the SSID byte's last), and
    the first and last sample of its transmission, the tail included."""
    destination: str
    source: str
    path: str
    control: int
    protocol: int
    info: str
    first_sample: int
    last_sample: int

    def key(self) -> tuple:
        return (self.destination, self.source, self.path, self.control,
                self.protocol, self.info)


def fcs(data: bytes) -> int:
    """CRC-16-CCITT as AX.25 sends it (X.25: reflected polynomial 0x8408,
    preset 0xFFFF, complemented), bit by bit."""
    reg = 0xFFFF
    for byte in data:
        for i in range(8):
            bit = (byte >> i) & 1
            reg = (reg >> 1) ^ 0x8408 if (reg ^ bit) & 1 else reg >> 1
    return reg ^ 0xFFFF


def address(call: str, ssid: int, high: int, last: bool) -> bytes:
    """An AX.25 address field: six characters shifted left one bit, then
    the SSID byte 0b H 1 1 SSID E, H the C or H bit, E the extension bit."""
    return (bytes(ord(c) << 1 for c in call.ljust(6))
            + bytes([(high << 7) | 0x60 | (ssid << 1) | int(last)]))


def callsigns(rng: np.random.Generator, n: int) -> list:
    """`n` distinct callsigns with SSIDs: a prefix of one or two letters,
    a digit, a suffix of one to three letters."""
    up = string.ascii_uppercase
    out = set()
    while len(out) < n:
        pre = "".join(rng.choice(list(up), int(rng.integers(1, 3))))
        suf = "".join(rng.choice(list(up), int(rng.integers(1, 4))))
        out.add((f"{pre}{int(rng.integers(0, 10))}{suf}", int(rng.integers(0, 16))))
    return sorted(out)


def _text(rng, n: int) -> str:
    return rng.choice(PRINTABLE, n).tobytes().decode() if n > 0 else ""


def info_field(rng: np.random.Generator, n: int, calls: list) -> str:
    """An APRS info field of `n` printable bytes: a position report, a
    message or a status (APRS Protocol Reference 1.0.1, chapters 8, 14 and
    16), its free text drawn to fill `n`."""
    kind = int(rng.integers(0, 3))
    if kind == 0:
        lat, lon = rng.uniform(0, 90), rng.uniform(0, 180)
        head = (f"!{int(lat):02d}{(lat % 1) * 60:05.2f}{'NS'[rng.integers(0, 2)]}/"
                f"{int(lon):03d}{(lon % 1) * 60:05.2f}{'EW'[rng.integers(0, 2)]}-")
        return head + _text(rng, n - len(head))
    if kind == 1:
        to, _ = calls[int(rng.integers(0, len(calls)))]
        head, tail = f":{to.ljust(9)}:", "{" + f"{int(rng.integers(0, 100)):02d}"
        return head + _text(rng, n - len(head) - len(tail)) + tail
    return ">" + _text(rng, n - 1)


def stuff(bits: list) -> list:
    """HDLC bit stuffing: a 0 after every five 1s in a row."""
    out, run = [], 0
    for b in bits:
        out.append(b)
        run = run + 1 if b else 0
        if run == 5:
            out.append(0)
            run = 0
    return out


def frame_bits(dest: tuple, src: tuple, digi: str, control: int, pid: int,
               info: str) -> tuple[list, str, str, str]:
    """The unstuffed bits of one UI frame, each byte least significant bit
    first, the FCS's low byte first; and its three address strings as the
    decoder renders them."""
    addrs = [address(dest[0], dest[1], 1, False), address(src[0], src[1], 0, False),
             address(digi, 0, 1, True)]
    body = b"".join(addrs) + bytes([control, pid]) + info.encode()
    crc = fcs(body)
    data = body + bytes([crc & 0xFF, crc >> 8])
    shown = ["".join(chr(b >> 1) for b in a) for a in addrs]
    return [(byte >> i) & 1 for byte in data for i in range(8)], *shown


def plan(seconds: float, cfg: dict, traffic: dict, seed: int
         ) -> tuple[np.ndarray, np.ndarray, list, list, list]:
    """The pass's transmissions from the seed: (first sample of each,
    NRZI levels of each as one array, bauds of each, samples of each
    tail, planted frames).
    A gap follows each transmission, the transmission's bauds times
    (1 - share) / share times a factor drawn from `gap_spread`, so that
    about `on_air_share` of the pass is on air."""
    rng = np.random.default_rng([seed, 0xA95])
    fs, baud = int(cfg["sample_rate"]), int(cfg["baud"])
    ax = cfg["ax25"]
    calls = callsigns(rng, int(traffic["callsigns"]))
    share = float(traffic["on_air_share"])
    n = int(round(seconds * fs))
    lo_info, hi_info = traffic["info_bytes"]
    lo_pre, hi_pre = traffic["preamble_flags"]
    lo_end, hi_end = traffic["closing_flags"]
    starts, levels, lengths, tails, frames, seen = [], [], [], [], [], set()
    t = int(rng.integers(0, int(traffic["first_gap_s"] * fs)))
    level = 1
    while True:
        src = calls[int(rng.integers(0, len(calls)))]
        dest = (ax["tocalls"][int(rng.integers(0, len(ax["tocalls"])))], 0)
        info = info_field(rng, int(rng.integers(lo_info, hi_info + 1)), calls)
        bits, d, s, p = frame_bits(dest, src, ax["digipeater"], int(ax["control"]),
                                   int(ax["pid"]), info)
        wire = (list(FLAG) * int(rng.integers(lo_pre, hi_pre + 1)) + stuff(bits)
                + list(FLAG) * int(rng.integers(lo_end, hi_end + 1)))
        tail = int(rng.uniform(*traffic["tail_s"]) * fs)
        last = t + -(-len(wire) * fs // baud) + tail - 1
        if last >= n - fs // 10:
            break
        key = (d, s, p, info)
        if key not in seen:            # the check matches frames by content
            seen.add(key)
            lev = level ^ np.cumsum(1 - np.asarray(wire, np.int64)) % 2  # 0 flips
            level = int(lev[-1])
            starts.append(t)
            levels.append(lev)
            lengths.append(len(wire))
            tails.append(tail)
            frames.append(Frame(d, s, p, int(ax["control"]), int(ax["pid"]), info,
                                t, last))
        gap = len(wire) * (1 - share) / share * rng.uniform(*traffic["gap_spread"])
        t = last + 1 + int(gap * fs / baud)
    return (np.asarray(starts, np.int64),
            np.concatenate(levels) if levels else np.zeros(0, np.int64),
            lengths, tails, frames)


def pass_bytes(seconds: float, cfg: dict, traffic: dict, device, seed: int,
               chunk: int = 1 << 24) -> tuple[torch.Tensor, list]:
    """The pass of `seconds` as interleaved uint8 IQ on `device`, and its
    planted frames in order."""
    fs, baud = int(cfg["sample_rate"]), int(cfg["baud"])
    starts, levels, lengths, tails, frames = plan(seconds, cfg, traffic, seed)
    if not frames:
        raise ValueError(f"no transmission fits in a pass of {seconds} s")
    n = int(round(seconds * fs))
    dev = torch.device(device)
    st = torch.as_tensor(starts, device=dev)
    base = torch.as_tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]), device=dev)
    ln = torch.as_tensor(np.asarray(lengths, np.int64), device=dev)
    # samples a transmission holds its carrier: its bauds, then its tail
    held = torch.as_tensor(-(-np.asarray(lengths, np.int64) * fs // baud)
                           + np.asarray(tails, np.int64), device=dev)
    lev = torch.as_tensor(levels, device=dev)
    mark, space = float(cfg["mark_hz"]), float(cfg["space_hz"])
    dev_hz, d_hz = float(cfg["deviation_hz"]), float(cfg["doppler_hz"])
    tau, mid = float(cfg["doppler_tau_s"]), 0.5 * seconds
    a_h, a_p = float(cfg["amplitude_horizon"]), float(cfg["amplitude_peak"])
    out = torch.empty(2 * n, dtype=torch.uint8, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tone0 = torch.zeros((), dtype=torch.float64, device=dev)
    fm0 = torch.zeros((), dtype=torch.float64, device=dev)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.int64, device=dev)
        k = (torch.searchsorted(st, t, right=True) - 1).clamp(min=0)
        local = (t - st[k]) * baud // fs
        keyed = (local >= 0) & (local < ln[k])
        on = (t >= st[k]) & (t - st[k] < held[k])
        bit = lev[(base[k] + local.clamp(0)).clamp(max=len(levels) - 1)]
        freq = torch.where(keyed & (bit == 0), space, mark).double()
        tone = tone0 + torch.cumsum((2 * np.pi / fs) * freq, 0)
        fm = fm0 + torch.cumsum((2 * np.pi * dev_hz / fs) * torch.cos(tone)
                                * keyed.double(), 0)
        tone0, fm0 = tone[-1].remainder(2 * np.pi), fm[-1].remainder(2 * np.pi)
        u = t.double() / fs - mid
        doppler = (-2 * np.pi * d_hz) * (torch.sqrt(u * u + tau * tau) - tau)
        amp = (a_h + (a_p - a_h) * (1 - (u / mid) ** 2)) * on.double()
        bb = torch.polar(amp, fm + doppler)
        _to_bytes(out, s, e, bb, fs, int(cfg["offset_hz"]), float(cfg["noise"]), gen)
    return out, frames
