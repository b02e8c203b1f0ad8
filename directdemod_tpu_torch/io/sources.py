"""IQ capture sources.

Port of `directdemod_tpu/io/sources.py:26-288`. The byte contract: a capture
is interleaved uint8 (I0 Q0 I1 Q1 ...), sample s being
``(I + jQ) - (127.5 + 127.5j)``; WAV files are 2-channel uint8 SDRSharp
recordings, DAT files raw bytes. `limit(offset, end)` windows every later
read. File sources stay memory-mapped on the host; `DeviceRawSource` holds
the bytes as a uint8 tensor on a device (the card, for `--resident`), and
decoders then slice it there instead of copying blocks over.
"""
from __future__ import annotations

import logging
import struct

import numpy as np
import torch

from .. import constants
from ..device import resolve

log = logging.getLogger(__name__)


def _wav_data_offset(path: str) -> tuple[int, int, int]:
    """Parse a RIFF/WAVE header: (data_offset, sample_rate, n_channels)."""
    with open(path, "rb") as f:
        riff = f.read(12)
        if riff[:4] != b"RIFF" or riff[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        rate, nch = None, None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk found")
            tag, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if tag == b"fmt ":
                fmt = f.read(size)
                nch = struct.unpack("<H", fmt[2:4])[0]
                rate = struct.unpack("<I", fmt[4:8])[0]
            elif tag == b"data":
                return f.tell(), rate, nch
            else:
                f.seek(size, 1)


class _Windowed:
    """The `limit` window shared by every source: reads are relative to
    `_offset` and at most `length` samples long. `source_type` and
    `sourceType` give the kind (`constants.SOURCE_IQWAV` / `SOURCE_IQDAT`),
    as the reference's property surface does (ref source.py:18-47)."""

    _total: int
    source_type = constants.SOURCE_IQDAT

    def _init_window(self, total: int) -> None:
        self._total = int(total)
        self._offset = 0
        self._limit = self._total

    @property
    def sourceType(self) -> int:
        return self.source_type

    @property
    def length(self) -> int:
        return self._limit

    def limit(self, init_offset: int | None = None,
              final_limit: int | None = None) -> None:
        """Window subsequent reads (ref source.py:120-138)."""
        self._offset = init_offset if init_offset is not None else 0
        self._limit = (final_limit - self._offset if final_limit is not None
                       else self._total)

    # the reference's name
    limitData = limit

    def _span(self, from_index: int, to_index: int | None) -> tuple[int, int]:
        if to_index is None:
            to_index = from_index + 1
        if (from_index < 0 or to_index < 0 or from_index >= self.length
                or to_index > self.length):
            raise ValueError("read range outside the source window")
        return self._offset + from_index, self._offset + to_index


def _u8_to_c64(raw: np.ndarray) -> np.ndarray:
    f = np.asarray(raw).astype(np.float32)
    out = np.empty(len(f) // 2, dtype=np.complex64)
    out.real = f[0::2] - np.float32(127.5)
    out.imag = f[1::2] - np.float32(127.5)
    return out


class _HostBytes(_Windowed):
    """A host byte array (usually a memmap) of interleaved uint8 IQ."""

    def __init__(self, data: np.ndarray, samp_freq: int):
        self._bytes = data
        self.memmap = data            # the whole byte stream (Doppler waterfall)
        self.sampFreq = int(samp_freq)
        self._init_window(len(data) // 2)

    def read(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        """complex64 samples in [from_index, to_index) of the window."""
        return _u8_to_c64(self.read_raw(from_index, to_index))

    def read_raw(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        """Raw interleaved uint8 bytes of samples [from_index, to_index)."""
        a, b = self._span(from_index, to_index)
        return self._bytes[2 * a: 2 * b]


class IQWav(_HostBytes):
    """SDRSharp IQ.wav source; the rate comes from the header unless given."""

    source_type = constants.SOURCE_IQWAV

    def __init__(self, filename: str, given_samp_freq: int | None = None):
        off, rate, nch = _wav_data_offset(filename)
        if nch not in (None, 2):
            raise ValueError(f"{filename}: expected 2-channel IQ wav, got {nch}")
        data = np.memmap(filename, dtype=np.uint8, mode="r", offset=off)
        super().__init__(data, given_samp_freq or rate)


class IQWavAlt(_HostBytes):
    """The header-skipping WAV reader of the reference's Experiment-2
    variant (ref source.py:237-324): the standard 44-byte header is skipped
    unread, and the rate defaults to the SDR's."""

    source_type = constants.SOURCE_IQWAV

    def __init__(self, filename: str, given_samp_freq: int | None = None):
        data = np.memmap(filename, dtype=np.uint8, mode="r", offset=44)
        super().__init__(data, given_samp_freq or int(constants.IQ_SDRSAMPRATE))


class IQDat(_HostBytes):
    """Raw interleaved uint8 .dat source."""

    def __init__(self, filename: str, given_samp_freq: int | None = None):
        data = np.memmap(filename, dtype=np.uint8, mode="r")
        super().__init__(data, given_samp_freq or int(constants.IQ_SDRSAMPRATE))


class ArraySource(_Windowed):
    """In-memory complex samples, with the file sources' surface."""

    def __init__(self, samples: np.ndarray, samp_freq: int):
        self._a = np.asarray(samples)
        self.sampFreq = int(samp_freq)
        self._init_window(len(self._a))

    def read(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        a, b = self._span(from_index, to_index)
        return self._a[a:b]


class DeviceRawSource(_Windowed):
    """A capture held as raw interleaved uint8 bytes in a 1-D tensor on
    `device` (the card). Decoders slice it where it lies; `read` and
    `read_raw` copy to the host for host-side consumers."""

    def __init__(self, raw: torch.Tensor, samp_freq: int):
        if raw.dtype != torch.uint8 or raw.dim() != 1:
            raise ValueError("DeviceRawSource wants a 1-D uint8 tensor")
        self._raw = raw.contiguous()
        self.sampFreq = int(samp_freq)
        self._init_window(raw.shape[0] // 2)

    @classmethod
    def from_host_bytes(cls, raw: np.ndarray, samp_freq: int, device):
        return cls(torch.from_numpy(np.array(raw, dtype=np.uint8)).to(device),
                   samp_freq)

    @classmethod
    def from_file(cls, path: str, samp_freq: int, device=None):
        """A raw .dat file's bytes, held on `device` (the port's device
        rule, `device.resolve`)."""
        return cls.from_host_bytes(np.fromfile(path, dtype=np.uint8), samp_freq,
                                   resolve(device))

    @property
    def device(self) -> torch.device:
        return self._raw.device

    def read_raw_device(self, from_index: int, to_index: int | None = None
                        ) -> torch.Tensor:
        a, b = self._span(from_index, to_index)
        return self._raw[2 * a: 2 * b]

    def read_raw(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        return self.read_raw_device(from_index, to_index).cpu().numpy()

    def read(self, from_index: int, to_index: int | None = None) -> np.ndarray:
        return _u8_to_c64(self.read_raw(from_index, to_index))


def resident_copy(sigsrc, device) -> DeviceRawSource | None:
    """The (already windowed) source's raw bytes as a DeviceRawSource on
    `device`, or None (with a log line) when they should not go there: on a
    card the bytes may take at most half of its free memory, the rest being
    the decode's working set."""
    device = torch.device(device)
    n = int(sigsrc.length)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        if 2 * n > free // 2:
            log.warning("capture is %.2f GB of raw bytes, over half of the "
                        "%.2f GB free on %s; not holding it there",
                        2 * n / 2**30, free / 2**30, device)
            return None
    return DeviceRawSource.from_host_bytes(sigsrc.read_raw(0, n),
                                           sigsrc.sampFreq, device)


def open_source(filename: str, given_samp_freq: int | None = None):
    """Dispatch by extension like the CLI does (ref main.py:133-138)."""
    if filename.endswith(".wav"):
        return IQWav(filename, given_samp_freq)
    if filename.endswith(".dat"):
        return IQDat(filename, given_samp_freq)
    raise ValueError("only .wav and .dat sources are supported")
