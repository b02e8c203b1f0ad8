"""The port's map overlay (`directdemod_tpu_torch.models.geo`, a host copy
of the JAX package's `models/geo.py`) against the JAX module: a counterpart
of each test of tests/test_geo.py, on the same inputs, with the same fake
pyorbital and renderer modules put into sys.modules (neither machine has
pyorbital, basemap or cartopy), and the `parse_tle` fault both copies keep
(a satellite name that starts with "1 " is read as a bare line 1).
"""
import logging
import os
import sys
import types
from datetime import datetime

import numpy as np
import pytest

from directdemod_tpu.models import geo as jgeo
from directdemod_tpu_torch import constants
from directdemod_tpu_torch.models import geo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TLE = os.path.join(ROOT, "tle", "noaa18_synthetic.txt")


# ---------------------------------------------------------------- pure parts

def test_bearing_reversed_convention():
    assert geo.bearing_deg(0.0, 0.0, 0.0, 1.0) == pytest.approx(270.0)
    assert geo.bearing_deg(0.0, 0.0, 1.0, 0.0) == pytest.approx(360.0)
    assert geo.bearing_deg(1.0, 0.0, 0.0, 0.0) == pytest.approx(180.0)
    rng = np.random.default_rng(0)
    for p in rng.uniform(-80, 80, size=(20, 4)):
        assert geo.bearing_deg(*p) == jgeo.bearing_deg(*p)


def test_offset_latlon_roundtrip():
    one_deg_m = 6371000.0 * np.pi / 180.0
    lat, lon = geo.offset_latlon([10.0, 20.0], 0.0, one_deg_m)
    assert lat == pytest.approx(11.0) and lon == pytest.approx(20.0)
    lat, lon = geo.offset_latlon([60.0, 0.0], one_deg_m, 0.0)
    assert lat == pytest.approx(60.0)
    assert lon == pytest.approx(1.0 / np.cos(np.radians(60.0)))
    assert geo.offset_latlon([50.0, 10.0], -1234.5, 987.0) == \
        jgeo.offset_latlon([50.0, 10.0], -1234.5, 987.0)


def test_capture_time_from_filename():
    for name in ("SDRSharp_20190521_170204Z_137500000Hz_IQ.wav", "capture.wav",
                 "x_20190521_1702Z_y.wav", "x_baddate_170204Z_y.wav"):
        assert geo.capture_time_from_filename(name) == \
            jgeo.capture_time_from_filename(name)
    assert geo.capture_time_from_filename(
        "SDRSharp_20190521_170204Z_137500000Hz_IQ.wav") == datetime(2019, 5, 21, 17, 2, 4)


# ------------------------------------------------------------- mocked overlay

class _FakeOrbital:
    """Deterministic southbound pass over 50N 10E."""

    def __init__(self, satellite, tle_file=None):
        self.satellite = satellite
        self.tle_file = tle_file

    def get_lonlatalt(self, when: datetime):
        s = when.timestamp() % 10000
        return (10.0, 50.0 - s * 1e-4, 850.0)


def _install_fake(monkeypatch, name, **attrs):
    mod = types.ModuleType(name)
    for k, v in attrs.items():
        setattr(mod, k, v)
    monkeypatch.setitem(sys.modules, name, mod)
    return mod


@pytest.fixture
def fake_pyorbital(monkeypatch):
    _install_fake(monkeypatch, "pyorbital")
    _install_fake(monkeypatch, "pyorbital.orbital", Orbital=_FakeOrbital)


def _no_renderers(monkeypatch):
    monkeypatch.setitem(sys.modules, "mpl_toolkits.basemap", None)
    monkeypatch.setitem(sys.modules, "cartopy", None)
    monkeypatch.setitem(sys.modules, "cartopy.crs", None)


def _image(rows=24):
    rng = np.random.default_rng(0)
    return rng.integers(0, 255, size=(rows, 1040), dtype=np.uint8)


def test_overlay_without_pyorbital(monkeypatch, tmp_path, caplog):
    monkeypatch.setitem(sys.modules, "pyorbital", None)
    monkeypatch.setitem(sys.modules, "pyorbital.orbital", None)
    with caplog.at_level("ERROR", logger="directdemod_tpu_torch.models.geo"):
        out = geo.map_overlay(_image(), datetime(2019, 5, 21), "NOAA 19",
                              str(tmp_path / "r.png"), str(tmp_path / "n.png"))
    assert out == [] == jgeo.map_overlay(_image(), datetime(2019, 5, 21), "NOAA 19",
                                         str(tmp_path / "r.png"), str(tmp_path / "n.png"))
    assert "pyorbital not installed" in caplog.messages
    assert not os.listdir(tmp_path)


def test_overlay_without_any_renderer(monkeypatch, tmp_path, caplog):
    """pyorbital present, basemap AND cartopy missing -> error + no files
    (ref decode_noaa.py:125-132)."""
    _install_fake(monkeypatch, "pyorbital")
    _install_fake(monkeypatch, "pyorbital.orbital", Orbital=_FakeOrbital)
    _no_renderers(monkeypatch)
    with caplog.at_level("WARNING", logger="directdemod_tpu_torch.models.geo"):
        out = geo.map_overlay(_image(), datetime(2019, 5, 21), "NOAA 19",
                              str(tmp_path / "r.png"), str(tmp_path / "n.png"))
    assert out == []
    assert any("basemap not installed" in m for m in caplog.messages)
    assert any("cartopy not installed" in m for m in caplog.messages)


def _fake_basemap(monkeypatch, calls):
    class _FakeBasemap:
        def __init__(self, **kw):
            calls.setdefault("init", []).append(kw)

        def drawcoastlines(self, **kw):
            calls["coast"] = True

        def drawcountries(self, **kw):
            calls["countries"] = True

    _install_fake(monkeypatch, "mpl_toolkits.basemap", Basemap=_FakeBasemap)


def test_overlay_basemap_preferred(fake_pyorbital, monkeypatch, tmp_path):
    """A fake basemap renders and is preferred; the reverse-rotated no-rot
    image comes from the rendered png, as the JAX module's does."""
    from PIL import Image
    calls = {}
    _fake_basemap(monkeypatch, calls)
    outs = {}
    for name, mod in (("port", geo), ("jax", jgeo)):
        rot, norot = tmp_path / f"{name}_rot.png", tmp_path / f"{name}_norot.png"
        out = mod.map_overlay(_image(), datetime(2019, 5, 21, 17, 2, 4), "NOAA 19",
                              str(rot), str(norot))
        assert out == [str(rot), str(norot)] and rot.exists() and norot.exists()
        outs[name] = np.asarray(Image.open(norot))
    assert calls["init"][0]["projection"] == "cass"
    assert calls["init"][0] == calls["init"][1]
    assert calls["coast"] and calls["countries"]
    assert outs["port"].shape[1] == 910      # cropped back to 995-85 columns
    assert np.array_equal(outs["port"], outs["jax"])


def test_overlay_from_filename_glue(fake_pyorbital, monkeypatch, tmp_path, caplog):
    class _Dec:
        image_a = _image()

    _no_renderers(monkeypatch)
    with caplog.at_level("ERROR", logger="directdemod_tpu_torch.models.geo"):
        assert geo.map_overlay_from_filename(
            _Dec(), "SDRSharp_20190521_170204Z_137500000Hz_IQ.wav", 137_000_000,
            "r.png", "n.png", None) == []
        assert geo.map_overlay_from_filename(
            _Dec(), "capture.wav", 137_100_000, "r.png", "n.png", None) == []
    assert "This satellite frequency not found" in caplog.messages
    assert "Was not able to get time from file name" in caplog.messages
    assert constants.NOAA_SATS == {137_620_000: "NOAA 15", 137_100_000: "NOAA 19",
                                   137_912_500: "NOAA 18"}


# --------------------------------------------------------------- TLE handling

def test_parse_tle_fixture():
    tles = geo.parse_tle(TLE)
    assert tles == jgeo.parse_tle(TLE) and "NOAA 18" in tles
    l1, l2 = geo.select_tle(TLE, "noaa 18")
    assert l1.startswith("1 28654U") and l2.startswith("2 28654")


def test_parse_tle_rejects_corruption(tmp_path):
    good = ("NOAA 18\n"
            "1 28654U 05018A   26233.50000000  .00000100  00000-0  60000-4 0  9991\n"
            "2 28654  98.8500 210.0000 0014000 120.0000 240.2500 14.12500000 10005\n")
    p = tmp_path / "t.txt"
    p.write_text(good)
    assert "NOAA 18" in geo.parse_tle(str(p))
    p.write_text(good.replace("98.8500", "98.8600"))
    assert "NOAA 18" in geo.parse_tle(str(p))
    p.write_text(good[: len(good) // 2])
    for mod in (geo, jgeo):
        with pytest.raises(ValueError):
            mod.parse_tle(str(p))
    p.write_text(good)
    for mod in (geo, jgeo):
        with pytest.raises(KeyError):
            mod.select_tle(str(p), "METEOR M2")


def test_parse_tle_3le_and_bare_formats(tmp_path):
    name, l1, l2 = open(TLE).read().strip().splitlines()[:3]
    p3 = tmp_path / "three.tle"
    p3.write_text(f"0 {name}\n{l1}\n{l2}\n")
    assert name.strip() in geo.parse_tle(str(p3))
    assert geo.parse_tle(str(p3)) == jgeo.parse_tle(str(p3))
    p2 = tmp_path / "bare.tle"
    p2.write_text(f"{l1}\n{l2}\n")
    assert l1[2:7] in geo.parse_tle(str(p2))
    assert geo.parse_tle(str(p2)) == jgeo.parse_tle(str(p2))


def test_parse_tle_checksum_warns_not_fails(tmp_path, caplog):
    name, l1, l2 = open(TLE).read().strip().splitlines()[:3]
    bad1 = l1[:68] + str((int(l1[68]) + 1) % 10)
    p = tmp_path / "ck.tle"
    p.write_text(f"{name}\n{bad1}\n{l2}\n")
    with caplog.at_level(logging.WARNING):
        tles = geo.parse_tle(str(p))
    assert name.strip() in tles
    assert any("checksum" in r.message for r in caplog.records)


def test_parse_tle_trailing_truncated_entry_raises(tmp_path):
    name, l1, l2 = open(TLE).read().strip().splitlines()[:3]
    p = tmp_path / "trunc.tle"
    p.write_text(f"{name}\n{l1}\n{l2}\nLEFTOVER SAT\n{l1}\n")
    for mod in (geo, jgeo):
        with pytest.raises(ValueError, match="truncated"):
            mod.parse_tle(str(p))


def test_parse_tle_misreads_a_name_starting_with_one(tmp_path):
    """The fault both copies keep (ROADMAP §3): a 3-line entry whose name
    starts with "1 " is taken for a bare 2-line entry, so its name line is
    read as line 1 and the entry is refused as malformed."""
    _, l1, l2 = open(TLE).read().strip().splitlines()[:3]
    p = tmp_path / "one.tle"
    p.write_text(f"1 WEIRD SAT\n{l1}\n{l2}\n")
    errors = []
    for mod in (geo, jgeo):
        with pytest.raises(ValueError, match="malformed") as e:
            mod.parse_tle(str(p))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
