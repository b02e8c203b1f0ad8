"""Tunables and protocol constants of the NOAA APT, AFSK1200, PSK and FM
slices (with the NOAA satellites' downlink frequencies of the map overlay),
and the filter kinds of the filter facade.

Copy of the matching entries of `directdemod_tpu/constants.py` (the JAX
package cannot be imported without importing jax). Values must stay
identical to it: block boundaries, sync trains and thresholds are part of
the decoders' numeric contract (`tests/test_torch_ops.py` checks them).
"""

# ---------------------------------------------------------------- IQ capture defaults
IQ_FREQOFFSET = 30_000          # default channel offset in Hz
IQ_SDRSAMPRATE = 2_048_000      # default SDR sample rate in Hz

# ---------------------------------------------------------------- stream processing
PROC_CHUNKSIZE = 20_000_000     # samples per stream block. Block boundaries are
                                # part of the numeric contract: the strict
                                # resample is applied per block.

# ---------------------------------------------------------------- filter kinds (ops/filters.butter)
FLT_LP = 0
FLT_HP = 1
FLT_BP = 2
FLT_BS = 3

# ---------------------------------------------------------------- NOAA APT protocol
NOAA_FMBW = 60_000              # FM bandwidth target before demod
NOAA_AUDSAMPRATE = 20_800       # audio output rate
NOAA_CRUDESYNCSAMPRATE = 40_960  # requested crude-sync rate; the effective rate after
                                 # integer-stride decimation is int(2048000/34) = 60235 Hz
NOAA_T = 1.0 / 4160             # seconds per APT "bit" (word)

# 40-word sync trains preceding channel A / channel B lines
NOAA_SYNCA = (0, 0, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0,
              1, 1, 0, 0, 1, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
NOAA_SYNCB = (0, 0, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1,
              1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0)

NOAA_PEAKHEIGHTWIGGLE = 0.25    # allowed fractional drop below mean peak height
NOAA_MINPEAKDIST = 0.45         # minimum sync spacing in seconds
NOAA_COLORCORRECT_FIFOLEN = 10_000
NOAA_DETECTMAXCHANGE = 5        # max jitter (samples) for the usefulness test
NOAA_DETECTCONSSYNCSNUM = 10    # consecutive syncs required for usefulness
NOAA_SATS = {137_620_000: "NOAA 15", 137_100_000: "NOAA 19", 137_912_500: "NOAA 18"}

# ---------------------------------------------------------------- AFSK1200 / APRS
AFSK_BAUDRATE = 1200
AFSK_MARK_HZ = 1200
AFSK_SPACE_HZ = 2200
AFSK_DEFAULT_BW = 22_050

# ---------------------------------------------------------------- Funcube BPSK
FUNCUBE_SYMRATE = 12_000
FUNCUBE_DEFAULT_BW = 7_000
FUNCUBE_SYNC_BITS = "101000110001000000000001010111100"  # 33-bit frame sync
FUNCUBE_FRAME_SPACING_S = 4.98

# ---------------------------------------------------------------- Meteor-M2 QPSK
METEOR_SYMRATE = 72_000
METEOR_DEFAULT_BW = 70_000
METEOR_FRAME_SPACING_S = 0.11
