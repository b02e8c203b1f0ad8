"""Seeded NOAA APT pass as 8-bit IQ bytes, made on the device.

Frozen copy of `chip_smoke.py:151-200` (`SYNCA`, `SYNCB`, `apt_line_words`,
`synth_pass_bytes`) with three changes: every signal parameter comes from
the configuration and the workload; each line has the layout of the NOAA
KLM User's Guide section 4.2 (sync, space with minute markers, 909 image
words, 45 telemetry words, for each channel), the telemetry strips
carrying the 128-line frame of 16 eight-line wedges; and the picture and
the telemetry are drawn from the seed, so that two seeds decode two
different passes of the same size.
"""
from __future__ import annotations

import numpy as np
import torch

# APT sync trains (before channel A / channel B) as the decoder's 40-word
# needles; the first 39 words are the sync, the 40th the space's first
SYNCA = (0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0,
         1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
SYNCB = (0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1,
         1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0)
BLACK, WHITE = 11.0, 244.0          # the sync trains' two levels


def layout(cfg) -> dict:
    """Word offsets of one channel's parts within its half line."""
    lay = cfg["line_layout"]
    o_space = lay["sync"]
    o_image = o_space + lay["space"]
    o_tel = o_image + lay["image"]
    assert o_tel + lay["telemetry"] == cfg["words_per_line"] // 2
    return {"space": o_space, "image": o_image, "telemetry": o_tel,
            "half": cfg["words_per_line"] // 2}


def wedge_levels(cfg, rng) -> np.ndarray:
    """(2, 16) word levels of the telemetry frame's wedges for channels A
    and B: wedges 1-8 at n/8 of full scale, 9 at zero, 10-13 the platinum
    thermometers, 14 the patch, 15 the back scan, 16 the channel's
    identity (the level of wedge `channel_id`)."""
    tel = cfg["telemetry"]
    steps = [255.0 * n / 8 for n in range(1, 9)]
    prt = rng.uniform(*tel["prt_range"])
    thermo = list(prt + rng.uniform(-tel["prt_spread"], tel["prt_spread"], 4))
    patch = prt + rng.uniform(-tel["patch_spread"], tel["patch_spread"])
    out = []
    for ch in ("a", "b"):
        back = prt + rng.uniform(*tel[f"back_scan_{ch}"]) \
            if tel[f"back_scan_{ch}"] else BLACK
        ident = steps[int(tel[f"channel_id_{ch}"]) - 1]
        out.append(steps + [0.0] + thermo + [patch, back, ident])
    return np.asarray(out)


def picture(n_lines: int, cfg, seed: int) -> np.ndarray:
    """(n_lines, words_per_line) word lines of a pass drawn from `seed`:
    each channel's 909 image words a ramp across the line plus a seeded
    texture that drifts from line to line (30..220, so no word clips); the
    spaces black (A) and white (B), with a minute marker (2 lines black, 2
    white) every 120 lines; the telemetry words at the level of the wedge
    the line lies in, the frame and the minutes starting at seeded lines."""
    lay = layout(cfg)
    tel = cfg["telemetry"]
    rng = np.random.default_rng(seed)
    n_img = cfg["line_layout"]["image"]
    ramp = np.linspace(30.0, 220.0, n_img)
    tex = rng.uniform(-1.0, 1.0, (2, n_img))
    drift = np.cumsum(rng.normal(0.0, 0.05, (n_lines, 2)), axis=0)
    levels = wedge_levels(cfg, rng)
    frame_lines = int(tel["frame_lines"])
    wedge_lines = int(tel["wedge_lines"])
    frame0 = int(rng.integers(0, frame_lines))
    minute_lines = int(tel["minute_lines"])
    minute0 = int(rng.integers(0, minute_lines))
    lines = np.empty((n_lines, cfg["words_per_line"]))
    for i in range(n_lines):
        wedge = ((i + frame0) % frame_lines) // wedge_lines
        marker = (i + minute0) % minute_lines
        for c, (sync, space) in enumerate(((SYNCA, BLACK), (SYNCB, WHITE))):
            h = lay["half"] * c
            content = (ramp, ramp[::-1])[c] + 12.0 * tex[c] * np.cos(drift[i, c])
            if marker < 4:
                space = BLACK if marker < 2 else WHITE
            lines[i, h:h + lay["space"]] = np.asarray(sync[:lay["space"]]) \
                * (WHITE - BLACK) + BLACK
            lines[i, h + lay["space"]:h + lay["image"]] = space
            lines[i, h + lay["image"]:h + lay["telemetry"]] = np.clip(content, 30, 220)
            lines[i, h + lay["telemetry"]:h + lay["half"]] = levels[c, wedge]
    return lines


def pass_bytes(n_lines: int, cfg, noise: float, device, seed: int,
               chunk: int = 1 << 25) -> tuple[torch.Tensor, np.ndarray]:
    """APT capture of `n_lines` lines and the first half of the next (the
    recording ends after its channel A) as interleaved uint8 IQ on
    `device`: the subcarrier AM of the line words, FM onto the channel
    offset with the phase integral carried in fp64 from chunk to chunk,
    complex noise of `noise` per component, quantized like an 8-bit SDR.
    Returns (bytes, the n_lines + 1 word lines)."""
    fs = int(cfg["sample_rate"])
    word_rate, sub_hz = float(cfg["word_rate"]), float(cfg["subcarrier_hz"])
    offset_hz, dev_hz = float(cfg["offset_hz"]), float(cfg["deviation_hz"])
    lines = picture(n_lines + 1, cfg, seed)
    words = torch.as_tensor(lines.reshape(-1), dtype=torch.float64, device=device)
    n = int((n_lines * 0.5 + 0.25) * fs)
    out = torch.empty(2 * n, dtype=torch.uint8, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phase0 = torch.zeros((), dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        t = torch.arange(s, e, dtype=torch.float64, device=device) / fs
        widx = torch.clamp((t * word_rate).long(), max=words.shape[0] - 1)
        env = 0.05 + 0.9 * words[widx] / 255.0
        baseband = env * torch.cos(2 * np.pi * sub_hz * t)
        dphi = 2 * np.pi * (offset_hz / fs) + 2 * np.pi * dev_hz * baseband / fs
        phase = phase0 + torch.cumsum(dphi, 0)
        phase0 = torch.remainder(phase[-1], 2 * np.pi)
        for k, part in enumerate((torch.cos(phase), torch.sin(phase))):
            noisy = part + noise * torch.randn(e - s, dtype=torch.float64,
                                               device=device, generator=gen)
            out[2 * s + k: 2 * e: 2] = torch.clamp(
                torch.round(noisy * 90.0 + 127.5), 0, 255).to(torch.uint8)
    return out, lines
