"""The port's command line (`directdemod_tpu_torch.cli`) for `-d noaa`,
`-d afsk1200`, `-d funcube` and `-d meteor`: the reference's flag grammar
and quirks, the JSON report, and the products held against the JAX
package's CLI on the same IQ.wav (image within one uint8 level on under 1 %
of pixels, accurate syncs within +/-1 sample, see tests/test_torch_noaa.py
for why; the same APRS payload; the same PSK sync CSV)."""
import functools
import json
import logging
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from directdemod_tpu import cli as jcli
from directdemod_tpu_torch import cli
from tests.apt_synth import synthesize
from tests.test_cli import _write_wav
from tests.test_torch_afsk import _capture
import chip_smoke

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "SDRSharp_20170830_073907Z_137590000Hz_IQ.wav"
# the port's CLI on the CPU: without a CUDA device `cli.main` must be told
main_cpu = functools.partial(cli.main, device="cpu")
# one line of the log's format, "%(asctime)s - %(name)s - %(levelname)s - %(message)s"
LOG_LINE = re.compile(r"^\d{4}-\d\d-\d\d \d\d:\d\d:\d\d,\d{3} - (\S+) - "
                      r"(DEBUG|INFO|WARNING|ERROR|CRITICAL) - (.*)$")


@pytest.fixture(autouse=True)
def _own_log(tmp_path, monkeypatch):
    """Both CLIs add a `log.txt` file handler and a console handler to the
    root logger on every run: each test runs in its own directory and takes
    away the handlers it added."""
    monkeypatch.chdir(tmp_path)
    root = logging.getLogger()
    before, level = list(root.handlers), root.level
    yield
    _drop_handlers(before)
    root.setLevel(level)


@pytest.fixture(scope="module")
def noaa_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli") / NAME)
    iq, _ = synthesize(n_lines=12, snr_db=20)
    _write_wav(path, iq)
    return path


def _csv_columns(path):
    rows = open(path).read().strip().splitlines()
    header = rows[0].split(",")[:-1]
    cols = {h: [] for h in header}
    for r in rows[1:]:
        for h, v in zip(header, r.split(",")[:-1]):
            if v not in ("", "None"):
                cols[h].append(float(v))
    return cols


def test_cli_matches_jax_cli(noaa_wav, tmp_path, monkeypatch):
    """Same arguments to both CLIs: the same report entries, an image within
    tolerance and the same sync CSV within +/-1 sample."""
    monkeypatch.chdir(tmp_path)
    outs, reps = {}, {}
    for name, main in (("port", main_cpu), ("jax", jcli.main)):
        outs[name] = str(tmp_path / name)
        reps[name] = str(tmp_path / f"{name}.json")
        rc = main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", outs[name], "-sync", "-r", reps[name], noaa_wav])
        assert rc == 0
    port = json.load(open(reps["port"]))
    ref = json.load(open(reps["jax"]))
    assert port["centreFreq"] == ref["centreFreq"] and port["invIQ"] == ref["invIQ"]
    p, r = port["channels"][0], ref["channels"][0]
    for key in ("frequency", "offset", "usefulness", "syncDetect", "image",
                "resident", "decoder"):
        assert p[key] == r[key], key
    assert p["device"] == "cpu" and p["decodeSeconds"] > 0
    assert [os.path.basename(f) for f in p["filesCreated"]] == \
        [os.path.basename(f).replace("jax", "port") for f in r["filesCreated"]]
    a = np.asarray(Image.open(outs["port"] + ".png")).astype(np.int64)
    b = np.asarray(Image.open(outs["jax"] + ".png")).astype(np.int64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1 and np.mean(a != b) < 0.01
    cp, cj = _csv_columns(outs["port"] + ".csv"), _csv_columns(outs["jax"] + ".csv")
    assert list(cp) == list(cj) and len(cp) == 8
    for col in ("syncA", "syncB"):
        assert len(cp[col]) == len(cj[col]) > 0
        assert np.max(np.abs(np.subtract(cp[col], cj[col]))) <= 1


def test_cli_sync_flag_quirk(noaa_wav, tmp_path):
    """-sync parses as ('-s', 'ync') and is not taken as a start index;
    -noimage as ('-n', 'oimage')."""
    report = str(tmp_path / "r.json")
    out = str(tmp_path / "o2")
    rc = main_cpu(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", out, "-sync", "-noimage", "-r", report, noaa_wav])
    assert rc == 0
    ch = json.load(open(report))["channels"][0]
    assert ch["syncDetect"] is True and ch["image"] is False
    assert ch["startFlag"] is None
    assert out + ".csv" in ch["filesCreated"]
    assert not os.path.exists(out + ".png")
    assert open(out + ".csv").readline().count(",") == 8


def test_cli_iq_swap_negates_offset(noaa_wav, tmp_path):
    report = str(tmp_path / "r.json")
    assert main_cpu(["-q", "-c", "137590000", "-f", "137620000", "-d", "noaa",
                     "-noimage", "-r", report, noaa_wav]) == 0
    rep = json.load(open(report))
    assert rep["invIQ"] is True and rep["channels"][0]["offset"] == -30000


def test_cli_failing_channel_is_fenced(noaa_wav, tmp_path):
    """A channel that fails (a start past the capture) does not kill the
    run: the report is written, without the channel."""
    report = str(tmp_path / "r.json")
    rc = main_cpu(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-s", "99999999999", "-r", report, noaa_wav])
    assert rc == 0
    assert json.load(open(report))["channels"] == []


def test_cli_resident_equals_blocked(noaa_wav, tmp_path):
    """--resident copies the capture into a DeviceRawSource and decodes it
    there; the image equals the blocked feed's bit for bit."""
    pngs = []
    for extra in ([], ["--resident"]):
        out = str(tmp_path / f"o{len(extra)}")
        rep = str(tmp_path / f"r{len(extra)}.json")
        assert main_cpu(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                         "-o", out, "-r", rep] + extra + [noaa_wav]) == 0
        ch = json.load(open(rep))["channels"][0]
        assert ch["usefulness"] == 1 and ch["resident"] is bool(extra)
        pngs.append(np.asarray(Image.open(out + ".png")))
    assert np.array_equal(pngs[0], pngs[1])


def test_cli_noise_only_capture(tmp_path):
    rng = np.random.default_rng(0)
    n = 2048000
    iq = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    path = str(tmp_path / NAME)
    _write_wav(path, iq, scale=60.0)
    report = str(tmp_path / "r.json")
    out = str(tmp_path / "noise_out")
    assert main_cpu(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                     "-o", out, "-r", report, path]) == 0
    assert json.load(open(report))["channels"][0]["usefulness"] == 0
    assert not os.path.exists(out + ".png")


APRS_NAME = "SDRSharp_20200101_000000Z_145813000Hz_IQ.wav"


@pytest.fixture(scope="module")
def aprs_wav(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cli_aprs") / APRS_NAME)
    _write_wav(path, _capture(["cli parity payload"]), scale=100.0)
    return path


def test_cli_afsk_matches_jax_cli(aprs_wav, tmp_path, monkeypatch, capsys):
    """-d afsk1200 with the centre frequency from the file name (-ce): both
    CLIs print the payload and report the same channel."""
    monkeypatch.chdir(tmp_path)
    reps, printed = {}, {}
    for name, main in (("port", main_cpu), ("jax", jcli.main)):
        reps[name] = str(tmp_path / f"{name}.json")
        capsys.readouterr()
        assert main(["-ce", "-f", "145825000", "-d", "afsk1200", "-r",
                     reps[name], aprs_wav]) == 0
        printed[name] = capsys.readouterr().out
    assert "cli parity payload" in printed["port"]
    assert "cli parity payload" in printed["jax"]
    port = json.load(open(reps["port"]))
    ref = json.load(open(reps["jax"]))
    assert port["centreFreq"] == ref["centreFreq"] == 145813000
    p, r = port["channels"][0], ref["channels"][0]
    for key in ("frequency", "offset", "usefulness", "decoder", "filesCreated",
                "resident"):
        assert p[key] == r[key], key
    assert p["usefulness"] == 1 and p["offset"] == 12000
    assert p["device"] == "cpu" and p["decodeSeconds"] > 0


def test_cli_afsk_noise_only_capture(tmp_path, capsys):
    rng = np.random.default_rng(2)
    n = 400_000
    iq = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    path = str(tmp_path / APRS_NAME)
    _write_wav(path, iq, scale=60.0)
    report = str(tmp_path / "r.json")
    assert main_cpu(["-c", "145813000", "-f", "145825000", "-d", "afsk1200",
                     "-r", report, path]) == 0
    assert capsys.readouterr().out.strip().endswith("None")
    assert json.load(open(report))["channels"][0]["usefulness"] == 0


TIMINGS = ("decodeSeconds", "residentUploadSeconds", "device")


def _both_clis(args, tmp_path, monkeypatch):
    """Run both CLIs on the same arguments, each in its own directory with
    `-o out -r rep.json`; returns {name: (report, directory)}."""
    got, before = {}, list(logging.getLogger().handlers)
    for name, main in (("port", main_cpu), ("jax", jcli.main)):
        os.mkdir(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        assert main(args[:-1] + ["-o", "out", "-r", "rep.json", args[-1]]) == 0, name
        _drop_handlers(before)
        got[name] = (json.load(open(tmp_path / name / "rep.json")), tmp_path / name)
    return got


def _same_report(got):
    """The reports are equal but for the timings (and the port's device);
    the channel entries name the same files."""
    (p, _), (r, _) = got["port"], got["jax"]
    p, r = dict(p), dict(r)
    p.pop("timeOfExec"), r.pop("timeOfExec")
    pch = [{k: v for k, v in c.items() if k not in TIMINGS} for c in p.pop("channels")]
    rch = [{k: v for k, v in c.items() if k not in TIMINGS} for c in r.pop("channels")]
    assert p == r and pch == rch and len(pch) == 1
    return pch[0]


def _same_image(got, name="out.png"):
    a = np.asarray(Image.open(got["port"][1] / name)).astype(np.int64)
    b = np.asarray(Image.open(got["jax"][1] / name)).astype(np.int64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= 1 and np.mean(a != b) < 0.01


def test_cli_map_without_pyorbital_like_jax_cli(noaa_wav, tmp_path, monkeypatch):
    """--map where pyorbital is missing (as on both machines): both CLIs log
    the error and write the image, and no map file."""
    monkeypatch.setitem(sys.modules, "pyorbital", None)
    monkeypatch.setitem(sys.modules, "pyorbital.orbital", None)
    got = _both_clis(["-c", "137590000", "-f", "137620000", "-d", "noaa", "--map",
                      noaa_wav], tmp_path, monkeypatch)
    ch = _same_report(got)
    assert ch["filesCreated"] == ["out.png"] and ch["usefulness"] == 1
    _same_image(got)
    for name in ("port", "jax"):
        assert "pyorbital not installed" in open(got[name][1] / "log.txt").read()
        assert sorted(os.listdir(got[name][1])) == ["log.txt", "out.png", "rep.json"]


def test_cli_map_with_bundled_tle_like_jax_cli(noaa_wav, tmp_path, monkeypatch):
    """--map --tle=tle/noaa18_synthetic.txt on a NOAA-18 channel, with a fake
    pyorbital and a fake basemap renderer: both CLIs take the satellite from
    the channel's frequency and the time from the file name, check the TLE
    file, and write the two map files beside the image."""
    from tests.test_torch_geo import _FakeOrbital, _fake_basemap, _install_fake
    _install_fake(monkeypatch, "pyorbital")
    _install_fake(monkeypatch, "pyorbital.orbital", Orbital=_FakeOrbital)
    _fake_basemap(monkeypatch, {})
    tle = os.path.join(ROOT, "tle", "noaa18_synthetic.txt")
    got = _both_clis(["-c", "137882500", "-f", "137912500", "-d", "noaa", "--map",
                      f"--tle={tle}", noaa_wav], tmp_path, monkeypatch)
    ch = _same_report(got)
    assert ch["filesCreated"] == ["out.png", "out_map_rot.png", "out_map.png"]
    _same_image(got)
    for f in ("out_map_rot.png", "out_map.png"):
        shapes = [np.asarray(Image.open(got[n][1] / f)).shape for n in ("port", "jax")]
        assert shapes[0] == shapes[1]


def test_cli_tle_without_map_like_jax_cli(noaa_wav, tmp_path, monkeypatch):
    """--tle alone is taken and changes nothing: no map is asked for."""
    got = _both_clis(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                      "--tle=tle/noaa18_synthetic.txt", noaa_wav], tmp_path, monkeypatch)
    assert _same_report(got)["filesCreated"] == ["out.png"]
    _same_image(got)


def test_cli_noaa_on_a_mesh_like_jax_cli(noaa_wav, tmp_path, monkeypatch):
    """--mesh=8 (the JAX test process's device count; the port's CPU shards)
    with -sync: the same report, the image within one level on under 1 % of
    pixels, the sync CSV within a sample (D12)."""
    got = _both_clis(["-c", "137590000", "-f", "137620000", "-d", "noaa", "--mesh=8",
                      "-sync", noaa_wav], tmp_path, monkeypatch)
    assert _same_report(got)["filesCreated"] == ["out.png", "out.csv"]
    _same_image(got)
    cp, cj = (_csv_columns(got[n][1] / "out.csv") for n in ("port", "jax"))
    assert list(cp) == list(cj)
    for col in ("syncA", "syncB"):
        assert len(cp[col]) == len(cj[col]) > 0
        assert np.max(np.abs(np.subtract(cp[col], cj[col]))) <= 1


def _meteor_iq():
    from tests.test_psk_sync import _qpsk_capture
    return _qpsk_capture([0.5 + i * 0.11 for i in range(5)], dur_s=1.4)


@pytest.mark.parametrize("decoder,name,freqs", [
    ("funcube", "fc_145865000Hz_IQ.wav", ["-c", "145865000", "-f", "145870000"]),
    ("meteor", "mm_137100000Hz_IQ.wav", ["-c", "137096000", "-f", "137100000"]),
])
def test_cli_psk_on_a_mesh_like_jax_cli(tmp_path, monkeypatch, decoder, name, freqs):
    """--mesh=8: the segment scan over the 8 shards (8 segments, the block
    loop); the same sync CSV. The Meteor capture is tests/test_psk_sync.py's
    QPSK stream, on which the segmented scans of both packages lock alike
    (on chip_smoke's noisier synthesis a segment of either side may miss a
    frame the other finds, see test_cli_psk_matches_jax_cli)."""
    path = str(tmp_path / name)
    if decoder == "funcube":
        raw, _ = chip_smoke.synth_funcube_bytes(7.3, "cpu", seed=11)
        _psk_wav(path, raw.numpy())
    else:
        _write_wav(path, _meteor_iq())
    got = _both_clis(freqs + ["-d", decoder, "--mesh=8", path], tmp_path, monkeypatch)
    ch = _same_report(got)
    assert ch["usefulness"] == 1 and ch["filesCreated"] == ["out.csv"]
    csvs = [open(got[n][1] / "out.csv").read() for n in ("port", "jax")]
    assert csvs[0] == csvs[1] and csvs[0].count("\n") >= 2


def test_cli_mesh_count_unlike_devices_raises_like_jax_cli(noaa_wav):
    """--mesh=2 where 8 devices are visible: both CLIs raise the mesh's
    ValueError outside the per-channel fence (on one card the port's
    --mesh=2 raises the same way, "have 1")."""
    args = ["-c", "137590000", "-f", "137620000", "-d", "noaa", "--mesh=2", noaa_wav]
    errors = []
    for main in (main_cpu, jcli.main):
        with pytest.raises(ValueError) as e:
            main(args)
        errors.append(str(e.value))
    assert errors[0] == errors[1] == "2x1 mesh needs 2 devices, have 8"


def test_python_m_entry_point():
    proc = subprocess.run([sys.executable, "-m", "directdemod_tpu_torch", "-h"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "Usage" in proc.stdout


def _psk_wav(path, raw: np.ndarray) -> str:
    chip_smoke.write_iq_wav(path, raw)
    return path


@pytest.mark.parametrize("decoder,extra,name,freqs,synth", [
    ("funcube", ["--freqshift"], "fc_145865000Hz_IQ.wav",
     ["-c", "145865000", "-f", "145870000"], "synth_funcube_bytes"),
    ("meteor", ["--segments=2"], "mm_137100000Hz_IQ.wav",
     ["-c", "137096000", "-f", "137100000"], "synth_meteor_bytes"),
])
def test_cli_psk_matches_jax_cli(tmp_path, monkeypatch, decoder, extra, name,
                                 freqs, synth):
    """-d funcube --freqshift and -d meteor --segments=2 on the same IQ.wav
    through both CLIs: the same report entries; the same Funcube sync CSV;
    every JAX Meteor sync among the port's. The segmented QPSK scans are
    the approximate mode, and their Gardner timing runs backwards at times,
    which turns the last-ulp differences of the two low-pass filters into
    other trajectories: a segment of either side may miss a frame the other
    finds (docs/experiments.md D13), never misplace one."""
    seconds = 7.3 if decoder == "funcube" else 0.5
    raw, _ = getattr(chip_smoke, synth)(seconds, "cpu", seed=11)
    wav = _psk_wav(str(tmp_path / name), raw.numpy())
    monkeypatch.chdir(tmp_path)
    reps, csvs = {}, {}
    for tag, main in (("port", main_cpu), ("jax", jcli.main)):
        reps[tag] = str(tmp_path / f"{tag}.json")
        assert main(freqs + ["-d", decoder] + extra
                    + ["-o", tag, "-r", reps[tag], wav]) == 0
        csvs[tag] = open(tmp_path / f"{tag}.csv").read()
    p = json.load(open(reps["port"]))["channels"][0]
    r = json.load(open(reps["jax"]))["channels"][0]
    for key in ("frequency", "offset", "usefulness", "decoder", "resident"):
        assert p[key] == r[key], key
    assert p["usefulness"] == 1 and p["device"] == "cpu"
    assert p["filesCreated"] == ["port.csv"] and r["filesCreated"] == ["jax.csv"]
    if decoder == "funcube":
        assert csvs["port"] == csvs["jax"] and csvs["port"].count("\n") >= 2
    else:
        rows = {k: v.splitlines() for k, v in csvs.items()}
        assert rows["port"][0] == rows["jax"][0] == "Meteor syncs,"
        assert set(rows["jax"][1:]) <= set(rows["port"][1:]) and len(rows["jax"]) > 2


def _log_records(path):
    """(logger, level, message) of each record in a log file; fails on a
    line outside the format (continuation lines of a traceback aside)."""
    recs = []
    for line in open(path).read().splitlines():
        m = LOG_LINE.match(line)
        assert m or not recs or line.startswith((" ", "Traceback")), line
        if m:
            recs.append(m.groups())
    return recs


def _drop_handlers(before):
    root = logging.getLogger()
    for h in root.handlers[:]:
        if h not in before:
            root.removeHandler(h)
            h.close()


def test_cli_writes_log_txt_like_jax_cli(noaa_wav, tmp_path, monkeypatch, capsys):
    """Each CLI writes log.txt into its working directory through the same
    setup: the file takes DEBUG and up and the console INFO and up, both in
    the JAX format, and the two CLIs log the same records (logger names
    aside)."""
    recs, before = {}, list(logging.getLogger().handlers)
    for name, main, pkg in (("port", main_cpu, "directdemod_tpu_torch"),
                            ("jax", jcli.main, "directdemod_tpu")):
        os.mkdir(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        capsys.readouterr()
        assert main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                     "-noimage", noaa_wav]) == 0
        logging.getLogger(pkg + ".models").debug("after the run")
        err = capsys.readouterr().err
        _drop_handlers(before)
        assert "Beginning decoding of frequency 1 of 1" in err
        assert "after the run" not in err
        recs[name] = [(n.replace(pkg, "pkg"), level, msg)
                      for n, level, msg in _log_records(tmp_path / name / "log.txt")]
    assert recs["port"] == recs["jax"]
    assert recs["port"][0] == ("root", "INFO", "Beginning decoding of frequency 1 of 1")
    assert recs["port"][-1] == ("pkg.models", "DEBUG", "after the run")


def test_cli_unknown_decoder_like_jax_cli(noaa_wav, tmp_path, monkeypatch, capsys):
    """A second channel with an unknown decoder: both CLIs decode the first
    channel and write its files, then print "Invalid decoder selected" and
    exit 1 without writing the report."""
    files, before = {}, list(logging.getLogger().handlers)
    for name, main in (("port", main_cpu), ("jax", jcli.main)):
        os.mkdir(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        capsys.readouterr()
        rc = main(["-c", "137590000", "-f", "137620000", "-d", "noaa",
                   "-o", "first", "-f", "137640000", "-d", "goes",
                   "-r", "rep.json", noaa_wav])
        assert rc == 1, name
        assert "Invalid decoder selected" in capsys.readouterr().out, name
        files[name] = sorted(os.listdir(tmp_path / name))
        _drop_handlers(before)
    assert files["port"] == files["jax"] == ["first.png", "log.txt"]


BANK_FREQS = (137_620_000, 137_912_500, 137_100_000)    # NOAA-15, -18, -19


@pytest.fixture(scope="module")
def bank_dat(tmp_path_factory):
    """A 6.25-s capture of three NOAA passes centred at 137.5 MHz (the
    `noaa_apt_3sat` channels) as a raw .dat file."""
    from benchmarks.synth import apt_bank
    with open(os.path.join(ROOT, "benchmarks", "configs", "noaa_apt_3sat.json")) as f:
        cfg = json.load(f)
    raw, _ = apt_bank.pass_bytes(12, cfg, 0.05, "cpu", 2 ** 31 + 31)
    path = str(tmp_path_factory.mktemp("cli_bank") / "bank.dat")
    raw.numpy().tofile(path)
    return path


def _k1_calls(monkeypatch) -> list:
    """Count the front end's K1 calls (the plain version on the CPU)."""
    from directdemod_tpu_torch.ops import ddc
    calls, orig = [], ddc.ddc_fm_u8

    def counted(*a, **k):
        calls.append(a[1].shape)
        return orig(*a, **k)
    monkeypatch.setattr(ddc, "ddc_fm_u8", counted)
    return calls


def test_cli_noaa_channels_share_one_bank(bank_dat, tmp_path, monkeypatch):
    """Three `-d noaa` channels of one capture go through one bank: one K1
    call for the three (one block), the same image files bit for bit, the
    same report entries (with "bank": 3) and the same sync CSVs (positions
    equal, qualities within 1e-6: the bank's accurate-sync batches hold
    other windows) as three one-channel runs."""
    calls = _k1_calls(monkeypatch)
    argv = ["-c", "137500000"]
    for n, f in enumerate(BANK_FREQS):
        argv += ["-f", str(f), "-d", "noaa", "-o", str(tmp_path / f"bank{n}")]
    assert main_cpu(argv + ["-sync", "-r", str(tmp_path / "bank.json"), bank_dat]) == 0
    assert len(calls) == 1 and tuple(calls[0]) == (3, 151)
    bank = json.load(open(tmp_path / "bank.json"))["channels"]
    for n, f in enumerate(BANK_FREQS):
        out = str(tmp_path / f"one{n}")
        assert main_cpu(["-c", "137500000", "-f", str(f), "-d", "noaa", "-o", out,
                         "-sync", "-r", out + ".json", bank_dat]) == 0
        one = json.load(open(out + ".json"))["channels"][0]
        got = {k: v for k, v in bank[n].items() if k not in TIMINGS}
        assert got.pop("bank") == 3 and "bank" not in one
        want = {k: v for k, v in one.items() if k not in TIMINGS}
        files = got.pop("filesCreated"), want.pop("filesCreated")
        got.pop("outFileName"), want.pop("outFileName")
        assert got == want and got["usefulness"] == 1
        assert [p.replace("bank", "one") for p in files[0]] == files[1]
        assert files[1] == [out + ".png", out + ".csv"]
        assert np.array_equal(np.asarray(Image.open(files[0][0])),
                              np.asarray(Image.open(files[1][0])))
        cb, co = _csv_columns(files[0][1]), _csv_columns(files[1][1])
        assert list(cb) == list(co)
        for col in cb:
            assert len(cb[col]) == len(co[col]) > 0
            if col.startswith("quality"):
                assert np.max(np.abs(np.subtract(cb[col], co[col]))) <= 1e-6
            elif col.startswith("TimeSync"):
                assert np.allclose(cb[col], co[col], rtol=1e-5, atol=0)
            else:
                assert cb[col] == co[col], col
    assert len(calls) == 4


def test_cli_noaa_channels_of_unlike_bandwidths_decode_one_by_one(bank_dat, tmp_path,
                                                                 monkeypatch):
    """NOAA channels of different bandwidths are no bank: a front end
    each."""
    calls = _k1_calls(monkeypatch)
    rep = str(tmp_path / "r.json")
    assert main_cpu(["-c", "137500000", "-f", str(BANK_FREQS[0]), "-d", "noaa",
                     "-b", "60000", "-f", str(BANK_FREQS[1]), "-d", "noaa", "-b",
                     "50000", "-noimage", "-r", rep, bank_dat]) == 0
    chans = json.load(open(rep))["channels"]
    assert [tuple(c) for c in calls] == [(1, 151), (1, 151)]
    assert [c["usefulness"] for c in chans] == [1, 1]
    assert all("bank" not in c for c in chans)


@pytest.mark.parametrize("bandwidths", [["60000", "60000"], ["60000", "50000"]],
                         ids=["bank", "one_by_one"])
def test_cli_resident_copies_once_a_run(bank_dat, tmp_path, monkeypatch, bandwidths):
    """--resident with two channels copies the capture to the device once,
    whether the channels share a bank or decode one by one."""
    from directdemod_tpu_torch.io import sources
    copies, orig = [], sources.resident_copy

    def counted(src, device):
        copies.append(src.length)
        return orig(src, device)
    monkeypatch.setattr(sources, "resident_copy", counted)
    rep = str(tmp_path / "r.json")
    argv = ["-c", "137500000"]
    for f, bw in zip(BANK_FREQS, bandwidths):
        argv += ["-f", str(f), "-d", "noaa", "-b", bw]
    assert main_cpu(argv + ["--resident", "-noimage", "-r", rep, bank_dat]) == 0
    chans = json.load(open(rep))["channels"]
    assert len(copies) == 1 and copies[0] == os.path.getsize(bank_dat) // 2
    assert [c["resident"] for c in chans] == [True, True]
    assert [c["usefulness"] for c in chans] == [1, 1]
    assert "residentUploadSeconds" in chans[0] and "residentUploadSeconds" not in chans[1]
