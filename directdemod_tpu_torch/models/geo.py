"""Map overlay for NOAA APT images (optional geo dependencies).

Host copy of `directdemod_tpu/models/geo.py:1-261` (the JAX package cannot
be imported without importing jax); the code is the same, NumPy on the
host. Behavioral reference: `decode_noaa.getMapImage` + the CLI's
satellite/time discovery (ref decode_noaa.py:98-253, main.py:232-265):
predict the satellite ground track with pyorbital, compute the track
bearing, rotate the channel-A image to north-up, render coastlines/borders
(cartopy preferred, basemap legacy), then reverse-rotate and crop back to
image coordinates.

All geo dependencies are optional; missing ones log an error and no files are
produced (matching the reference's graceful degradation). `parse_tle` keeps
the JAX copy's behaviour exactly, its misreading of a satellite name that
starts with "1 " included.
"""
from __future__ import annotations

import logging
from datetime import datetime, timedelta

import numpy as np

log = logging.getLogger(__name__)


def bearing_deg(lat1, lon1, lat2, lon2) -> float:
    """Initial bearing from point 1 to point 2, in the reference's reversed
    convention (ref decode_noaa.py:135-150)."""
    lat1, lon1, lat2, lon2 = map(np.radians, (lat1, lon1, lat2, lon2))
    dlon = lon2 - lon1
    y = np.sin(dlon) * np.cos(lat2)
    x = np.cos(lat1) * np.sin(lat2) - np.sin(lat1) * np.cos(lat2) * np.cos(dlon)
    brng = (np.degrees(np.arctan2(y, x)) + 360.0) % 360.0
    return 360.0 - brng


def offset_latlon(center, dx_m, dy_m):
    """Move a (lat, lon) point by meters (ref decode_noaa.py:208-212)."""
    lat = center[0] + (dy_m / 6371000.0) * (180.0 / np.pi)
    lon = center[1] + (dx_m / 6371000.0) * (180.0 / np.pi) \
        / np.cos(center[0] * np.pi / 180.0)
    return [lat, lon]


def capture_time_from_filename(file_name: str) -> datetime | None:
    """SDRSharp-style `..._YYYYMMDD_HHMMSSZ_...` stamp (ref main.py:242-254)."""
    parts = file_name.split("_")[::-1]
    for i, p in enumerate(parts):
        if p and p[-1] == "Z" and i + 1 < len(parts):
            d, t = parts[i + 1], p[:-1]
            try:
                return datetime(int(d[:4]), int(d[4:6]), int(d[6:8]),
                                int(t[:2]), int(t[2:4]), int(t[4:6]))
            except (ValueError, IndexError):
                return None
    return None


def parse_tle(path: str) -> dict:
    """Parse a NORAD two-line-element file into {satellite_name: (l1, l2)},
    validating line numbers and the mod-10 checksums (digits sum, '-' counts
    1). The reference hands TLE files straight to pyorbital
    (ref decode_noaa.py:131, main.py --tle); validating here turns a stale
    or truncated file into a clear error instead of a pyorbital stack
    trace, and keeps the selection logic testable without the optional geo
    dependencies (the bundled fixture is tle/noaa18_synthetic.txt)."""
    def _cksum(line: str) -> int:
        s = 0
        for ch in line[:68]:
            if ch.isdigit():
                s += int(ch)
            elif ch == "-":
                s += 1
        return s % 10

    out: dict[str, tuple[str, str]] = {}
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    i = 0
    while i < len(lines):
        # bare 2-line entries (no name line) are valid TLE files that
        # pyorbital accepts; key them by catalog number (ADVICE r04)
        if lines[i].startswith("1 "):
            name = ""
            l1, l2 = lines[i], lines[i + 1] if i + 1 < len(lines) else ""
            step = 2
        else:
            if i + 2 >= len(lines):
                raise ValueError(
                    f"{path}: truncated TLE entry at line {i + 1}")
            name, l1, l2 = lines[i], lines[i + 1], lines[i + 2]
            step = 3
        if not (l1.startswith("1 ") and l2.startswith("2 ")):
            raise ValueError(f"{path}: malformed TLE entry at line {i + 1}")
        for ln in (l1, l2):
            if len(ln) < 69:
                raise ValueError(f"{path}: TLE line too short: {ln!r}")
            if int(ln[68]) != _cksum(ln):
                # pyorbital tolerates checksum deviations; a hard failure
                # here aborted overlays that previously rendered (ADVICE
                # r04) — warn, keep structural errors fatal
                log.warning("%s: TLE checksum mismatch (tolerated): %r",
                            path, ln)
        if l1[2:7] != l2[2:7]:
            raise ValueError(f"{path}: catalog numbers differ: "
                             f"{l1[2:7]} vs {l2[2:7]}")
        # 3LE name lines carry a leading '0 ' (ADVICE r04)
        name = name.strip()
        if name.startswith("0 "):
            name = name[2:].strip()
        out[name or l1[2:7]] = (l1, l2)
        i += step
    if i != len(lines):
        raise ValueError(f"{path}: truncated TLE entry at line {i + 1}")
    if not out:
        raise ValueError(f"{path}: no TLE entries found")
    return out


def select_tle(path: str, satellite: str) -> tuple[str, str]:
    """The satellite's (line1, line2) from a TLE file; KeyError with the
    available names when absent (the reference's satellite-name lookup,
    ref main.py:232-241)."""
    tles = parse_tle(path)
    key = satellite.strip().upper()
    for name, pair in tles.items():
        if name.upper() == key:
            return pair
    raise KeyError(f"{satellite!r} not in {path}; "
                   f"available: {sorted(tles)}")


def _render_basemap(img, center, dest_rot) -> bool:
    """Legacy basemap renderer (ref decode_noaa.py:172-183): Cassini
    projection centered on the track midpoint, yellow coast/country lines.
    Returns False (caller falls through to cartopy) if basemap is absent."""
    try:
        from mpl_toolkits.basemap import Basemap
    except ImportError:
        log.warning("basemap not installed")
        return False
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = img.shape[:2]
    plt.figure()
    m = Basemap(projection="cass", lon_0=center[1], lat_0=center[0],
                width=w * 4000 * 0.81, height=h * 4000 * 0.81, resolution="i")
    m.drawcoastlines(color="yellow")
    m.drawcountries(color="yellow")
    plt.imshow(img, cmap="gray", extent=(*plt.xlim(), *plt.ylim()))
    plt.savefig(dest_rot, bbox_inches="tight", dpi=1000)
    plt.close()
    return True


def _render_cartopy(img, center, dest_rot) -> bool:
    """Cartopy renderer (ref decode_noaa.py:206-231): PlateCarree with the
    image extent derived by offsetting the track midpoint by half the image
    footprint in meters."""
    try:
        import cartopy.crs as ccrs
        import cartopy.feature
    except ImportError:
        log.error("Both basemap and cartopy not installed. "
                  "Please install either.")
        return False
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dx = img.shape[0] * 4000 / 2 * 0.81
    dy = img.shape[1] * 4000 / 2 * 0.81
    leftbot = offset_latlon(center, -dx, -dy)
    righttop = offset_latlon(center, dx, dy)
    extent = (leftbot[1], righttop[1], leftbot[0], righttop[0])

    plt.figure()
    ax = plt.axes(projection=ccrs.PlateCarree())
    ax.imshow(img, origin="upper", cmap="gray", extent=extent,
              transform=ccrs.PlateCarree())
    ax.coastlines(resolution="50m", color="yellow", linewidth=1)
    ax.add_feature(cartopy.feature.BORDERS, linestyle="-", edgecolor="yellow")
    plt.savefig(dest_rot, bbox_inches="tight", dpi=1000)
    plt.close()
    return True


def map_overlay(image_a: np.ndarray, capture_time: datetime, satellite: str,
                dest_rot: str, dest_norot: str, tle_file: str | None = None
                ) -> list:
    """Render the overlay; returns the list of files written.

    Renderer preference order matches the reference (decode_noaa.py:117-132):
    basemap first, cartopy as fallback, error when neither is available."""
    try:
        from pyorbital.orbital import Orbital
    except ImportError:
        log.error("pyorbital not installed")
        return []
    try:
        from scipy import ndimage
        from PIL import Image
    except ImportError:
        log.error("scipy/PIL not installed; cannot draw map")
        return []

    if tle_file is not None:
        try:
            select_tle(tle_file, satellite)      # validate before pyorbital
        except (OSError, ValueError, KeyError) as e:
            log.error("bad TLE file: %s", e)
            return []
    orb = Orbital(satellite) if tle_file is None else \
        Orbital(satellite, tle_file=tle_file)

    im = image_a[:, 85:995]            # crop sync/telemetry margins
    oim = im.copy()
    tdelta = max(int(im.shape[0] / 16), 10)
    mid_s = int(im.shape[0] / 4)
    top = orb.get_lonlatalt(capture_time + timedelta(seconds=mid_s - tdelta))[:2][::-1]
    bot = orb.get_lonlatalt(capture_time + timedelta(seconds=mid_s + tdelta))[:2][::-1]
    center = orb.get_lonlatalt(capture_time + timedelta(seconds=mid_s))[:2][::-1]
    rot = bearing_deg(*bot, *top)

    img = ndimage.rotate(im, rot)
    rimg = img.copy()
    if not (_render_basemap(img, center, dest_rot)
            or _render_cartopy(img, center, dest_rot)):
        return []
    created = [dest_rot]

    try:
        rendered = np.asarray(Image.open(dest_rot))
        rendered = rendered[109:-109, 109:-109, :]
        rendered = np.asarray(Image.fromarray(rendered).resize(
            (rimg.shape[1], rimg.shape[0])))
        back = -1 * (rot % 180) if 90 < (rot % 360) < 270 else -1 * rot
        rendered = ndimage.rotate(rendered, back)
        rf = int(rendered.shape[0] / 2 - oim.shape[0] / 2)
        cf = int(rendered.shape[1] / 2 - oim.shape[1] / 2)
        rendered = rendered[rf:rf + oim.shape[0], cf:cf + oim.shape[1]]
        Image.fromarray(rendered).save(dest_norot)
        created.append(dest_norot)
    except Exception:
        log.error("Image reverse rotation failed")
    return created


def map_overlay_from_filename(noaa_decoder, file_name: str, channel_freq,
                              dest_rot: str, dest_norot: str,
                              tle_file: str | None) -> list:
    """CLI glue: derive satellite + capture time (ref main.py:232-265)."""
    from .. import constants
    sat = constants.NOAA_SATS.get(channel_freq)
    if sat is None:
        log.error("This satellite frequency not found")
        return []
    when = capture_time_from_filename(file_name)
    if when is None:
        log.error("Was not able to get time from file name")
        return []
    return map_overlay(noaa_decoder.image_a, when, sat, dest_rot, dest_norot,
                       tle_file)
