"""Command-line interface of the port.

Port of `directdemod_tpu/cli.py:23-302` for the NOAA APT, AFSK1200, Funcube
and Meteor-M2 decoders, with every flag of the JAX CLI: the same
getopt grammar and its quirks (`-sync` parses as `-s ync`, `-noimage` as
`-n oimage`, `-ce` as `-c e`, the centre frequency then coming from the file
name), the same per-channel fence and the same JSON report (`-r`), with
`decodeSeconds`, `resident` and the `device` the channel ran on. The decode
runs on the current CUDA device; `main(argv, device="cpu")` runs it on the
CPU (the JAX CLI has no device flag, so neither has this one), and without a
CUDA device `main` raises unless it is given one. As in the JAX CLI, the
log goes to `log.txt` in the working directory (DEBUG) and to the console
(INFO), and an unknown decoder ends the run with "Invalid decoder selected"
and exit code 1 once the channels before it are decoded, writing no report.
`--mesh=<n>` (n > 1) builds an n-shard `time` mesh over the visible
devices (`parallel.mesh`; with `device="cpu"` the 8 CPU shards that stand
for the JAX tests' 8 virtual devices) before the channel loop, so a count
that differs from the devices raises, outside the per-channel fence, as the
JAX CLI does. `--map` (with `--tle=<file>`) draws the NOAA map overlay
(`models.geo`), which logs an error and writes nothing without pyorbital.
"""
from __future__ import annotations

import getopt
import json
import logging
import sys
from time import gmtime, perf_counter, strftime

from . import constants
from .device import resolve
from .io import sinks, sources
from .utils import logsetup

def usage(err: str = "") -> None:
    if err:
        print("ERROR :", err)
    prog = sys.argv[0]
    print(f"""Usage: {prog} [options] <IQ.wav>

Common options:
\t-c <Fc in Hz> : centre frequency of the recording
\t-ce : extract centre frequency from file name
\t-a <F in Hz> : sampling frequency of the recording
\t-q : switch I and Q channels
\t-r <filename> : generate report in JSON
\t-h : print this

Channels:
\t-f <in Hz> : For every channel add a -f flag with respective frequency
\tOptions for each channel: (if set, must follow -f of the respective channel)
\t\t-d <str> : decoder for this channel (noaa, afsk1200, funcube, meteor)
\t\t-b <in Hz> : channel bandwidth (in order)
\t\t-o <str> : output file names (in order)
\t\t-s <in sample#> : starts of signals (in order)
\t\t-e <in sample#> : ends of signals (in order)

Decoder flags:
\t-d noaa : APT decoder (-sync writes sync csv, --map map overlay,
\t          --tle=<file> TLE source, -noimage skips the image)
\t-d afsk1200 : APRS decoder (prints the last decoded payload)
\t-d funcube : Funcube BPSK sync detector (--freqshift Doppler correction)
\t-d meteor : Meteor QPSK sync detector
\t--mesh=<n> : shard the NOAA/PSK decode over an n-device time mesh
\t--segments=<n> : segment-parallel PLL scan for funcube/meteor
\t--resident : copy the capture once into device memory and decode from
\t             there (falls back to the blocked feed when it does not fit)
""")


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logsetup.setup("log.txt", console=True)

    try:
        optlist, args = getopt.getopt(
            argv, "c:f:s:e:ho:qn:b:d:r:a:",
            ["help", "map", "tle=", "freqshift", "mesh=", "segments=",
             "resident"])
    except getopt.GetoptError as e:
        usage(str(e))
        return 1

    flags = [o[0] for o in optlist]
    if "-h" in flags or "--help" in flags:
        usage()
        return 0
    map_draw = "--map" in flags
    if len(args) != 1:
        usage("Invalid argument: filename")
        return 1

    mesh = None
    mesh_n = next((int(v) for k, v in optlist if k == "--mesh"), 0)
    if mesh_n > 1:
        from .parallel import distributed
        from .parallel.mesh import make_mesh, visible_devices
        if distributed.world_size() > 1:
            raise ValueError("--mesh builds a mesh of one process; the CLI does "
                             "not run across processes")
        mesh = make_mesh(time=mesh_n, channel=1, devices=visible_devices(device))
    resident = "--resident" in flags
    corr_freq_shift = "--freqshift" in flags
    # --segments=<n>: segment-parallel PLL scan for the PSK decoders
    n_segments = next((int(v) for k, v in optlist if k == "--segments"), None)
    calc_sync = any(o == ("-s", "ync") for o in optlist)
    calc_image = not any(o == ("-n", "oimage") for o in optlist)
    report_file = next((v for k, v in optlist if k == "-r"), None)
    given_rate = next((int(v) for k, v in optlist if k == "-a"), None)

    freqs = [int(v) for k, v in optlist if k == "-f"]
    starts = [int(v) for k, v in optlist if k == "-s" and v != "ync"]
    ends = [int(v) for k, v in optlist if k == "-e"]
    outs = [v for k, v in optlist if k == "-o"]
    bandwidths = [int(v) for k, v in optlist if k == "-b"]
    decoders = [v for k, v in optlist if k == "-d"]

    if not freqs:
        freqs = [None]
    if len(freqs) != len(decoders):
        usage("Every -f channel must be accompanied by a decoder")
        return 1
    if max(len(starts), len(ends), len(outs), len(bandwidths)) > len(freqs):
        usage("number of starts/ends/outfilenames cannot be greater than frequencies given")
        return 1
    for lst in (starts, ends, outs, bandwidths):
        lst.extend([None] * (len(freqs) - len(lst)))

    device = resolve(device)
    file_name = args[0]
    try:
        sigsrc = sources.open_source(file_name, given_rate)
    except ValueError as e:
        usage(str(e))
        return 1

    report = {
        "inFileName": file_name,
        "timeOfExec": strftime("%Y-%m-%d %H:%M:%S", gmtime()),
        "invIQ": "-q" in flags,
        "channels": [],
    }

    for i in range(len(freqs)):
        try:
            entry = {"frequency": freqs[i], "bandwidth": bandwidths[i],
                     "decoder": decoders[i], "startFlag": starts[i],
                     "endFlag": ends[i], "outFileName": outs[i]}
            logging.info("Beginning decoding of frequency %d of %d", i + 1, len(freqs))

            freq_offset = constants.IQ_FREQOFFSET
            if freqs[i] is not None:
                explicit_c = [v for k, v in optlist if k == "-c" and v != "e"]
                if explicit_c:
                    freq_offset = freqs[i] - int(explicit_c[0])
                    report["centreFreq"] = explicit_c[0]
                else:
                    token = [t for t in file_name.split("_") if t[-2:] == "Hz"][0][:-2]
                    if token[-1] == "k":
                        centre = int(token[:-1]) * 1000
                    else:
                        centre = int(token)
                    freq_offset = freqs[i] - centre
                    report["centreFreq"] = centre
            if "-q" in flags:
                freq_offset *= -1
            entry["offset"] = freq_offset
            logging.info("Offset for this frequency: %f Hz", freq_offset)

            sigsrc.limit(starts[i], ends[i])
            src_i = sigsrc
            if resident:
                t_up = perf_counter()
                wrapped = sources.resident_copy(sigsrc, device)
                if wrapped is not None:
                    src_i = wrapped
                    entry["residentUploadSeconds"] = round(
                        perf_counter() - t_up, 3)
            t_dec = perf_counter()
            entry["resident"] = src_i is not sigsrc
            entry["device"] = str(device)
            stem = file_name.split(".")[0]
            entry["filesCreated"] = []

            if decoders[i] == "noaa":
                img_file = f"{stem}_f{i + 1}.png"
                color_file = f"{stem}_f{i + 1}_color.png"
                csv_file = f"{stem}_f{i + 1}.csv"
                map_rot = f"{stem}_f{i + 1}_map_rot.png"
                map_nrot = f"{stem}_f{i + 1}_map.png"
                if outs[i] is not None:
                    img_file, csv_file = outs[i] + ".png", outs[i] + ".csv"
                    color_file = outs[i] + "_color.png"
                    map_rot, map_nrot = outs[i] + "_map_rot.png", outs[i] + "_map.png"

                from .models.noaa import NoaaDecoder
                dec = NoaaDecoder(src_i, freq_offset, bandwidths[i], device=device,
                                  mesh=mesh)
                if calc_image and dec.useful == 1:
                    sinks.write_image(img_file, dec.get_image())
                    entry["filesCreated"].append(img_file)
                    ida, idb = dec.channel_id
                    if ida is not None and idb is not None:
                        logging.info("NOAA channel A id: %d, channel B id: %d", ida, idb)
                    if ida == 2 and idb == 4:
                        sinks.write_image(color_file, dec.get_color())
                        entry["filesCreated"].append(color_file)
                    else:
                        logging.info("image ineligible for false color")
                    if map_draw:
                        from .models import geo
                        created = geo.map_overlay_from_filename(
                            dec, file_name, freqs[i], map_rot, map_nrot,
                            next((v for k, v in optlist if k == "--tle"), None))
                        entry["filesCreated"].extend(created)
                if calc_sync and dec.useful == 1:
                    syncs = dec.get_accurate_sync(use_norm_correlate=True)
                    sinks.write_csv(csv_file, syncs,
                                    titles=["syncA", "diffSyncA", "qualityA",
                                            "TimeSyncA", "syncB", "diffSyncB",
                                            "qualityB", "TimeSyncB"])
                    entry["filesCreated"].append(csv_file)
                if dec.useful == 0:
                    logging.info("No NOAA data was found at this frequency")
                entry["usefulness"] = dec.useful
                entry["syncDetect"] = calc_sync
                entry["image"] = calc_image

            elif decoders[i] == "afsk1200":
                from .models.afsk1200 import Afsk1200Decoder
                dec = Afsk1200Decoder(src_i, freq_offset, bandwidths[i],
                                      device=device)
                print(dec.get_msg())
                entry["usefulness"] = dec.useful

            elif decoders[i] in ("funcube", "meteor"):
                if decoders[i] == "funcube":
                    from .models.funcube import FuncubeDecoder
                    dec = FuncubeDecoder(src_i, freq_offset, bandwidths[i],
                                         report.get("centreFreq"), freqs[i],
                                         corr_freq_shift, n_segments=n_segments,
                                         device=device, mesh=mesh)
                    title = "Funcube syncs"
                else:
                    from .models.meteorm2 import MeteorM2Decoder
                    dec = MeteorM2Decoder(src_i, freq_offset, bandwidths[i],
                                          n_segments=n_segments, device=device,
                                          mesh=mesh)
                    title = "Meteor syncs"
                syncs = dec.get_syncs()
                logging.info("Complete: detected %d syncs", len(syncs))
                csv_file = (f"{stem}_f{i + 1}.csv" if outs[i] is None
                            else outs[i] + ".csv")
                sinks.write_csv(csv_file, [syncs], titles=[title])
                entry["filesCreated"].append(csv_file)
                entry["usefulness"] = dec.useful
            else:
                usage("Invalid decoder selected")
                return 1

            entry["decodeSeconds"] = round(perf_counter() - t_dec, 3)
            report["channels"].append(entry)
        except Exception as e:  # per-channel fence (ref main.py:347-349)
            logging.error("An error occurred during decoding of frequency %d of %d",
                          i + 1, len(freqs))
            logging.error("The error is: %s", e)

    if report_file is not None:
        with open(report_file, "w") as f:
            json.dump(report, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
