"""Device DSP ops (host-side design in `design`); importing builds no kernel."""
from . import (am, correlate, crc, design, filters, fir, fm, iir, nco,  # noqa: F401
               peaks, peaks_extra, pll, resample)
