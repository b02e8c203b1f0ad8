"""AFSK1200 / APRS (AX.25) decoder.

Port of `directdemod_tpu/models/afsk1200.py`: FM front end -> Butterworth
bandpass 700-2700 Hz -> mark/space quadrature correlator bank -> edge
detection -> lookahead peak bit sync (K2) -> NRZI baud means -> flag scan ->
bit unstuffing -> CRC-16 check -> AX.25 header/payload parse.

The audio is the port's FM front end (`models/frontend.DdcFm`), which
computes exactly what the reference's complex-output front end followed by
its whole-stream discriminator angle(c[1:] conj(c[:-1]) rot) computes:
raw bytes held on the decoder's device go through `DdcFmStream` as one
block (one K1 launch), any other source block by block. The rest of the
chain runs on the decoder's device either way; only the sparse peak events
and the baud means go to the host, where the bit layer and framing are
NumPy as in the reference. Indices are int64 throughout; the reference's
float32 (hi, lo) index packing, its event cap and the overflow fallback to
a host chain are not ported (K2's event buffer cannot overflow).

As in the JAX package, `get_msg` returns the decoded AX.25 payload (the
reference stores a hardcoded placeholder, ref decode_afsk1200.py:283).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .. import constants as K
from ..io.feeder import BlockFeeder
from ..io.sources import device_bytes, resident_copy
from ..ops import crc, design, fir, iir, peaks
from .frontend import DdcFm, DdcFmStream
from .stages import TimedDecoder

log = logging.getLogger(__name__)


def _window_means(bf: torch.Tensor, starts: torch.Tensor, spb: int
                  ) -> torch.Tensor:
    """Mean of bf[s : s+spb] for each int64 start s, clipped at the stream
    end; empty windows give 0.0 like the reference's np.mean-of-empty guard
    (ref decode_afsk1200.py:198-205). One gather for all baud windows."""
    n = bf.shape[0]
    s0 = starts.clamp(max=n)
    win = F.pad(bf, (0, spb)).unfold(0, spb, 1)[s0]          # (m, spb)
    k = (n - s0).clamp(0, spb)
    mask = torch.arange(spb, device=bf.device)[None, :] < k[:, None]
    return (torch.where(mask, win, 0.0).sum(dim=-1)
            / k.clamp(min=1).to(bf.dtype))


@dataclass
class Ax25Frame:
    destination: str
    source: str
    path: str
    control: int | None
    protocol: int | None
    info: str
    start_bit: int


class Afsk1200Decoder(TimedDecoder):
    """Decode AFSK1200 APRS frames from an IQ source on `device`
    (`device` and `stage_seconds` as `TimedDecoder` gives them)."""

    layer = "afsk"

    def __init__(self, sigsrc, offset: float, bw: int | None = None,
                 device=None):
        self.src = sigsrc
        self.offset = float(offset)
        self.bw = int(bw) if bw else K.AFSK_DEFAULT_BW
        self._init_device(device)
        self._frames: list[Ax25Frame] | None = None
        self._useful = 0

    @property
    def useful(self) -> int:
        return self._useful

    # ------------------------------------------------------------- front end
    def _frontend(self) -> DdcFm:
        """offsetFreq -> blackman-harris(151) -> bwLim(bw) -> FM
        (ref decode_afsk1200.py:74-95) as the fused front end."""
        return DdcFm(self.src.sampFreq, self.offset,
                     design.blackmanharris(151), self.bw)

    @staticmethod
    def _bandpass(rate: int) -> iir.IirFilter:
        return iir.IirFilter.design_butter(
            rate, K.AFSK_MARK_HZ - 500, K.AFSK_SPACE_HZ + 500, order=6,
            kind="bandpass")

    def _baseband_audio(self) -> tuple[torch.Tensor, int]:
        """FM audio of the whole capture on the decoder's device through
        `DdcFmStream`: one block where the bytes are on the device (on a
        card a file source is copied there when `io.sources.resident_copy`
        lets it), else block by block."""
        src = self.src
        if (device_bytes(src, self.device) is None and self.device.type == "cuda"
                and callable(getattr(src, "read_raw", None))):
            src = resident_copy(src, self.device) or src
        whole = device_bytes(src, self.device) is not None
        fe = self._frontend()
        stream = DdcFmStream(fe, self.device)
        feed = BlockFeeder(src, K.PROC_CHUNKSIZE, self.device,
                           blocks=[(0, src.length)] if whole else None)
        outs = [stream.step(x, s) for s, _, x in feed]
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), fe.out_rate

    # ------------------------------------------------------------- bit layer
    def _binary_filter(self, sig: torch.Tensor) -> torch.Tensor:
        """Mark/space quadrature energy difference (ref
        decode_afsk1200.py:106-143): the four correlators as one 4-channel
        convolution; kernel timing uses the *nominal* bw like the reference,
        not the emergent decimated rate. The last `buf` samples stay zero,
        as in the reference."""
        buf = int(np.round(self.bw / K.AFSK_BAUDRATE))
        i = np.arange(buf) / self.bw
        kernels = np.stack([np.cos(2 * np.pi * K.AFSK_MARK_HZ * i),
                            np.sin(2 * np.pi * K.AFSK_MARK_HZ * i),
                            np.cos(2 * np.pi * K.AFSK_SPACE_HZ * i),
                            np.sin(2 * np.pi * K.AFSK_SPACE_HZ * i)])
        w = torch.as_tensor(kernels, dtype=torch.float32,
                            device=sig.device)[:, None, :]
        n_set = sig.shape[0] - buf
        mi, mq, si, sq = F.conv1d(sig.reshape(1, 1, -1), w)[0, :, :n_set]
        e = mi * mi + mq * mq - si * si - sq * sq
        return torch.cat([e, e.new_zeros(buf)])

    def _edge_strength(self, bf: torch.Tensor) -> torch.Tensor:
        """|edge correlation| of sign(bf) (ref decode_afsk1200.py:151-160):
        the input of the bit-boundary peak walk."""
        spb = self.bw // K.AFSK_BAUDRATE
        edge = torch.cat([-torch.ones(spb // 2), torch.ones(spb - spb // 2)])
        changes = fir.correlate_same(torch.sign(bf), edge.to(bf.device)) / spb
        return changes.abs()

    def _bit_boundaries(self, edges: torch.Tensor) -> np.ndarray:
        """Lookahead peaks of the edge strength (ref
        decode_afsk1200.py:161-178); returns the positive-peak sample
        positions (int64, host). Counts the samples K2 walks and its
        fires."""
        lookahead = int(self.bw // K.AFSK_BAUDRATE * 0.65)
        n = int(edges.shape[0])
        if n <= lookahead:
            return np.empty(0, np.int64)
        events = peaks.lookahead_events(edges, lookahead)
        self._count("bit_sync.samples", n - lookahead)
        self._count("bit_sync.events", int(events[0].shape[0]))
        (pk, _), _ = peaks.unpack_lookahead_events(events, lookahead, n)
        return pk

    def _nrzi_window_starts(self, pk: np.ndarray) -> np.ndarray:
        """Start positions of every NRZI baud window: each inter-peak gap of
        r bauds contributes windows pk[i] + k*spb, k < r (ref
        decode_afsk1200.py:187-207)."""
        spb = self.bw // K.AFSK_BAUDRATE
        spb_f = self.bw / K.AFSK_BAUDRATE
        reps = np.round(np.diff(pk) / spb_f).astype(np.int64)
        reps = np.maximum(reps, 0)
        tot = int(reps.sum())
        if tot == 0:
            return np.empty(0, np.int64)
        bases = np.repeat(pk[:-1], reps)
        run0 = np.concatenate([[0], np.cumsum(reps[:-1])])
        k = np.arange(tot) - np.repeat(run0, reps)
        return bases + k * spb

    def _nrzi_bits(self, bf: torch.Tensor, pk: np.ndarray) -> np.ndarray:
        """Expand inter-peak gaps into repeated NRZI bits: the sign of each
        baud window's mean of `bf` (ref decode_afsk1200.py:187-207)."""
        starts = self._nrzi_window_starts(pk)
        if len(starts) == 0:
            return np.empty(0)
        means = _window_means(bf, torch.as_tensor(starts, device=bf.device),
                              self.bw // K.AFSK_BAUDRATE)
        return np.sign(means.cpu().numpy())

    # ------------------------------------------------------------- framing
    @staticmethod
    def decode_nrzi(nrzi: np.ndarray) -> np.ndarray:
        """NRZI -> bits: 1 on no transition (ref decode_afsk1200.py:331-352)."""
        nrzi = np.asarray(nrzi)
        out = np.empty(len(nrzi), dtype=np.int64)
        out[0] = 1
        out[1:] = (nrzi[1:] == nrzi[:-1]).astype(np.int64)
        return out

    @staticmethod
    def find_bit_stuffing(bits: np.ndarray) -> np.ndarray:
        """Mark stuffed bits: 1 = stuffed 0 after five 1s, 2 = possible frame
        end (ref decode_afsk1200.py:354-385). The mark at i is "bits i-5 ..
        i-1 set and bit i-6 clear or before the start": five shifted ANDs
        over the bitstream."""
        bits = np.asarray(bits)
        n = len(bits)
        mark = np.zeros(n, dtype=bool)
        if n > 5:
            ones = bits != 0
            run5 = ones[:n - 5] & ones[1:n - 4] & ones[2:n - 3] \
                & ones[3:n - 2] & ones[4:n - 1]
            mark[5] = run5[0]
            mark[6:] = run5[1:] & ~ones[:n - 6]
        out = mark.astype(np.int64)
        out += mark & (bits == 1)
        return out

    @staticmethod
    def reduce_stuffed_bit(bits, stuffed) -> list:
        """Drop stuffed bits (ref decode_afsk1200.py:387-405)."""
        return [b for b, s in zip(bits, stuffed) if s == 0]

    @staticmethod
    def find_flags(bits: np.ndarray) -> np.ndarray:
        """Positions of the 01111110 frame flag (ref
        decode_afsk1200.py:219-230): eight shifted compares over the
        bitstream."""
        bits = np.asarray(bits)
        n = len(bits)
        if n < 8:
            return np.empty(0, dtype=np.int64)
        at = (bits[:n - 7] == 0) & (bits[7:] == 0)
        for k in range(1, 7):
            at &= bits[k:n - 7 + k] == 1
        return np.flatnonzero(at)

    @staticmethod
    def parse_ax25(msg_bits) -> Ax25Frame:
        """AX.25 header/payload parse (ref decode_afsk1200.py:291-328):
        bytes are LSB-first on the wire (a trailing partial byte is
        dropped); the header runs to the first byte with its extension
        (first transmitted) bit set, or to the end, its chars the bytes'
        upper seven bits; the payload's chars are its bytes."""
        bits = np.asarray(msg_bits, dtype=np.uint8)
        data = np.packbits(bits[:len(bits) // 8 * 8], bitorder="little")
        ends = np.flatnonzero(data & 1)
        h = int(ends[0]) + 1 if len(ends) else len(data)
        header = (data[:h] >> 1).tobytes().decode("latin-1")
        payload = data[h:].tobytes()
        return Ax25Frame(
            destination=header[:7], source=header[7:14], path=header[14:],
            control=payload[0] if len(payload) > 0 else None,
            protocol=payload[1] if len(payload) > 1 else None,
            info=payload[2:].decode("latin-1"), start_bit=0)

    # ------------------------------------------------------------- top level
    def get_frames(self) -> list[Ax25Frame]:
        """Run the full decode; returns the CRC-valid AX.25 frames. One
        `bit_sync` stage holds the filters and the walk, one `framing`
        stage the baud levels on the device and the host bit layer."""
        if self._frames is not None:
            return self._frames
        audio, rate = self._audio_stage()
        with self._stage("bit_sync"):
            with self._span("bit_sync.filters"):
                bf, edges = self._filters(audio, rate)
            del audio
            with self._span("bit_sync.walk"):
                pk = self._bit_boundaries(edges)
        with self._stage("framing"):
            with self._span("framing.levels"):
                nrzi = self._nrzi_bits(bf, pk) if len(pk) >= 2 else np.empty(0)
            with self._span("framing.frames"):
                self._frames = self._frames_from_nrzi(nrzi)
        return self._frames

    def _edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(bf, edge strength) of the whole capture on the decoder's device:
        FM audio -> bandpass -> correlator bank -> edge correlation."""
        audio, rate = self._audio_stage()
        with self._stage("bit_sync"), self._span("bit_sync.filters"):
            return self._filters(audio, rate)

    def _audio_stage(self) -> tuple[torch.Tensor, int]:
        """The `fm_frontend` stage: the capture's FM audio and its rate."""
        with self._stage("fm_frontend"):
            audio, rate = self._baseband_audio()
        log.info("AFSK: %d samples at %d Hz", audio.shape[0], rate)
        return audio, rate

    def _filters(self, audio: torch.Tensor, rate: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        """bandpass -> correlator bank -> edge correlation of the FM audio:
        (bf, edge strength)."""
        bp = self._bandpass(rate)
        sig, _ = bp.apply(audio, bp.initial_state_step(torch.float32,
                                                       audio.device))
        bf = self._binary_filter(sig)
        return bf, self._edge_strength(bf)

    def _frames_from_nrzi(self, nrzi: np.ndarray) -> list[Ax25Frame]:
        """NRZI -> bits -> flags -> unstuffed, CRC-checked AX.25 frames
        (ref decode_afsk1200.py:209-289), over the whole stream at once:
        the segment after flag f (its bits [f + 8, next flag)) unstuffed is
        a slice of the stream's unstuffed bits, its length a difference of
        a cumulative sum; the segments that pass the length tests are
        packed to bytes and CRC-checked in one batch."""
        if len(nrzi) == 0:
            return []
        bits = self.decode_nrzi(nrzi)
        keep = self.find_bit_stuffing(bits) == 0
        flags = self.find_flags(bits)
        self._count("framing.bauds", len(nrzi))
        self._count("framing.flags", len(flags))
        kept = np.concatenate([[0], np.cumsum(keep)])     # kept bits before i
        unstuffed = bits[keep].astype(np.uint8)
        # flags closer than 8 bits give a negative length: the length test
        # fails it, as it fails the empty slice
        lo = kept[flags[:-1] + 8]
        n = kept[flags[1:]] - lo
        seg = np.flatnonzero((n % 8 == 0) & (n - 16 > 16 * 8))
        lo, n = lo[seg], n[seg]
        self._count("framing.crc_checks", len(seg))
        # the checked segments back to back: each is whole bytes
        idx = np.repeat(lo - np.cumsum(n) + n, n) + np.arange(n.sum())
        data = np.packbits(unstuffed[idx], bitorder="little")
        frames = []
        for j in np.flatnonzero(crc.fcs_crc16_check(data, n // 8)):
            start = int(flags[seg[j]])
            frame = self.parse_ax25(unstuffed[lo[j]:lo[j] + n[j] - 16])
            frame.start_bit = start
            frames.append(frame)
            self._useful = 1
            log.info("APRS frame at bit %d: %s", start, frame.info)
        self._count("framing.frames", len(frames))
        return frames

    def get_msg(self) -> str | None:
        """Last decoded payload (the reference keeps only the last frame,
        ref decode_afsk1200.py:281-283)."""
        frames = self.get_frames()
        return frames[-1].info if frames else None
