"""NMEA 0183 sentence output: the lingua-franca wire format every GNSS
consumer (gpsd, chart plotters, u-center, mapping toolchains) speaks.

The reference has no machine-readable position output at all — fixes are
logged as strings and POSTed to its web dashboard
(reference: gypsum/receiver.py:138-146,277-293). Here every published fix
renders the standard talker sentences:

  GGA  time, lat/lon, fix quality, satellites used, HDOP, altitude
  GSA  fix mode, PRNs used, PDOP/HDOP/VDOP
  RMC  time+date, lat/lon, speed-over-ground, course-over-ground
  VTG  course + speed (knots and km/h)
  GSV  satellites in view (elevation/azimuth/C-N0), 4 per sentence
  ZDA  UTC time + date

Times are UTC: GPS system time minus the broadcast leap-second count
(subframe 4 page 18 when decoded — solve/iono.py:IonoUtcParams.delta_t_ls —
else the current constant 18 s). Coordinates are WGS-84, ddmm.mmmmm with
the standard hemisphere letters. Checksums per the spec: XOR of every
character between '$' and '*'.

A small parser for GGA/RMC closes the loop hermetically (tests round-trip
through it), mirroring how obs/rinex.py ships parse_obs/parse_nav beside
its writers.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np

from gypsum_tpu_torch.solve.geodesy import enu_basis

if TYPE_CHECKING:  # pragma: no cover
    from gypsum_tpu_torch.solve.world import ReceiverSolution

GPS_EPOCH = _dt.datetime(1980, 1, 6, 0, 0, 0)
_KNOTS_PER_MPS = 3600.0 / 1852.0
SECONDS_PER_WEEK = 604800.0


def checksum(body: str) -> str:
    """XOR of all characters between '$' and '*', as two uppercase hex."""
    c = 0
    for ch in body:
        c ^= ord(ch)
    return f"{c:02X}"


def make_sentence(body: str) -> str:
    return f"${body}*{checksum(body)}"


def _format_lat(lat_deg: float) -> tuple[str, str]:
    hemi = "N" if lat_deg >= 0 else "S"
    lat = abs(lat_deg)
    deg = int(lat)
    minutes = (lat - deg) * 60.0
    return f"{deg:02d}{minutes:08.5f}", hemi


def _format_lon(lon_deg: float) -> tuple[str, str]:
    hemi = "E" if lon_deg >= 0 else "W"
    lon = abs(lon_deg)
    deg = int(lon)
    minutes = (lon - deg) * 60.0
    return f"{deg:03d}{minutes:08.5f}", hemi


def _parse_angle(field: str, hemi: str) -> float:
    """ddmm.mmmmm / dddmm.mmmmm + hemisphere letter -> signed degrees."""
    dot = field.index(".")
    deg = int(field[: dot - 2])
    minutes = float(field[dot - 2 :])
    value = deg + minutes / 60.0
    return -value if hemi in ("S", "W") else value


def _speed_course(fix: "ReceiverSolution") -> tuple[float | None, float | None]:
    """Horizontal speed (m/s) and true course (deg, 0..360) from the fix's
    ECEF Doppler velocity, projected into the local ENU frame."""
    if fix.velocity_ecef_mps is None:
        return None, None
    east, north, _up = enu_basis(fix.ecef) @ np.asarray(fix.velocity_ecef_mps)
    speed = float(np.hypot(east, north))
    if speed < 1e-6:
        return speed, None  # course undefined when stationary
    return speed, float(np.degrees(np.arctan2(east, north)) % 360.0)


def utc_of_fix(world, fix: "ReceiverSolution") -> _dt.datetime | None:
    """UTC datetime of a fix: receiver stream time + the world model's
    GPS-time slide (already bias-corrected after each solve,
    solve/world.py), anchored to the decoded week number, minus the
    broadcast leap seconds."""
    if world.receiver_clock_slide is None:
        return None
    # Week anchor: same derivation the RINEX exporter uses.
    from gypsum_tpu_torch.obs.rinex import RinexObsWriter

    week = RinexObsWriter._week_from_world(world)
    if week is None:
        return None
    sow = float(fix.receiver_timestamp) + float(world.receiver_clock_slide)
    week += int(sow // SECONDS_PER_WEEK)  # normalize a rollover
    sow %= SECONDS_PER_WEEK
    leap = 18
    if getattr(world, "iono_utc", None) is not None:
        leap = int(world.iono_utc.delta_t_ls)
    return GPS_EPOCH + _dt.timedelta(weeks=week, seconds=sow - leap)


def _hms(when: _dt.datetime) -> str:
    return (
        f"{when.hour:02d}{when.minute:02d}"
        f"{when.second + when.microsecond / 1e6:05.2f}"
    )


def _quality(fix: "ReceiverSolution") -> int:
    """GGA fix-quality indicator: 2 = differential (any SBAS-corrected
    pseudorange in the solve), 6 = estimated (EKF coast, or an lsq fix whose
    RAIM chi-square test failed — solve/integrity.py:raim_residual_test:
    the residuals disagree with the formal weights, so downstream consumers
    should treat it as degraded), 1 = autonomous."""
    if fix.kind == "ekf":
        return 6
    if fix.raim is not None and not fix.raim.get("ok", True):
        return 6
    if fix.sbas_corrected:
        return 2
    return 1


def _mode_letter(fix: "ReceiverSolution") -> str:
    if fix.kind == "ekf":
        return "E"
    if fix.raim is not None and not fix.raim.get("ok", True):
        return "E"
    if fix.sbas_corrected:
        return "D"
    return "A"


def gga(fix: "ReceiverSolution", when: _dt.datetime, talker: str = "GP") -> str:
    lat, ns = _format_lat(fix.lat_deg)
    lon, ew = _format_lon(fix.lon_deg)
    hdop = fix.dop.get("hdop") if fix.dop else None
    hdop_s = f"{hdop:.2f}" if hdop is not None and np.isfinite(hdop) else ""
    # Altitude is WGS-84 ellipsoidal (the solver's native vertical datum);
    # with no geoid model on board, the geoid-separation field reports 0.0
    # so consumers can reconstruct the ellipsoidal height exactly.
    body = (
        f"{talker}GGA,{_hms(when)},{lat},{ns},{lon},{ew},{_quality(fix)},"
        f"{len(fix.satellites_used):02d},{hdop_s},{fix.alt_m:.1f},M,0.0,M,,"
    )
    return make_sentence(body)


def nmea_sat_id(world, prn: int) -> int | None:
    """NMEA satellite numbering: GPS 1-32 as-is, SBAS 33-51 (prn-87),
    GLONASS 65-96 (orbital slot + 64 — the slot comes from decoded string
    4; a channel whose slot is still unknown has no NMEA number yet)."""
    if 1 <= prn <= 32:
        return prn
    if 120 <= prn <= 138:
        return prn - 87
    if 201 <= prn <= 214 and world is not None:
        rec = world._sats.get(prn)
        glo = getattr(rec, "glonass", None) if rec is not None else None
        slot = int(getattr(glo, "slot", 0) or 0)
        return 64 + slot if slot >= 1 else None
    return None


def gsa(
    fix: "ReceiverSolution",
    talker: str = "GP",
    sat_ids: "list[int] | None" = None,
    system_id: int | None = None,
) -> str:
    """``sat_ids``: NMEA satellite numbers to list (defaults to the fix's
    satellites_used verbatim — the single-constellation GPS case).
    ``system_id``: NMEA 4.10 trailing GNSS system id (1 GPS, 2 GLONASS),
    emitted by multi-constellation receivers which send one GSA per
    system under the GN talker."""
    prns = (list(fix.satellites_used) if sat_ids is None else list(sat_ids))[:12]
    slots = ",".join(
        f"{p:02d}" if i < len(prns) else ""
        for i, p in enumerate(list(prns) + [0] * (12 - len(prns)))
    )
    d = fix.dop or {}

    def f(key: str) -> str:
        v = d.get(key)
        return f"{v:.2f}" if v is not None and np.isfinite(v) else ""

    body = f"{talker}GSA,A,3,{slots},{f('pdop')},{f('hdop')},{f('vdop')}"
    if system_id is not None:
        body += f",{system_id}"
    return make_sentence(body)


def rmc(fix: "ReceiverSolution", when: _dt.datetime, talker: str = "GP") -> str:
    lat, ns = _format_lat(fix.lat_deg)
    lon, ew = _format_lon(fix.lon_deg)
    speed, course = _speed_course(fix)
    speed_s = f"{speed * _KNOTS_PER_MPS:.2f}" if speed is not None else ""
    course_s = f"{course:.1f}" if course is not None else ""
    date = f"{when.day:02d}{when.month:02d}{when.year % 100:02d}"
    status = "V" if fix.kind == "ekf" else "A"
    body = (
        f"{talker}RMC,{_hms(when)},{status},{lat},{ns},{lon},{ew},"
        f"{speed_s},{course_s},{date},,,{_mode_letter(fix)}"
    )
    return make_sentence(body)


def vtg(fix: "ReceiverSolution", talker: str = "GP") -> str:
    speed, course = _speed_course(fix)
    course_s = f"{course:.1f}" if course is not None else ""
    kn = f"{speed * _KNOTS_PER_MPS:.2f}" if speed is not None else ""
    kmh = f"{speed * 3.6:.2f}" if speed is not None else ""
    body = f"{talker}VTG,{course_s},T,,M,{kn},N,{kmh},K,{_mode_letter(fix)}"
    return make_sentence(body)


def zda(when: _dt.datetime, talker: str = "GP") -> str:
    body = (
        f"{talker}ZDA,{_hms(when)},{when.day:02d},{when.month:02d},"
        f"{when.year:04d},00,00"
    )
    return make_sentence(body)


def gsv(
    sky: dict[int, "object"],
    cn0_dbhz: dict[int, float] | None = None,
    talker: str = "GP",
) -> list[str]:
    """Satellites-in-view sentences from predicted look geometry
    (solve/world.py:predicted_sky), 4 satellites per sentence."""
    visible = sorted(
        (p for p, s in sky.items() if s.elevation_deg > 0.0 and p <= 99),
    )
    if not visible:
        return []
    n_msgs = (len(visible) + 3) // 4
    out = []
    for m in range(n_msgs):
        fields = [f"{talker}GSV", str(n_msgs), str(m + 1), f"{len(visible):02d}"]
        for p in visible[m * 4 : m * 4 + 4]:
            s = sky[p]
            snr = (cn0_dbhz or {}).get(p)
            fields += [
                f"{p:02d}",
                f"{int(round(s.elevation_deg)):02d}",
                f"{int(round(s.azimuth_deg)) % 360:03d}",
                f"{int(round(snr)):02d}" if snr is not None else "",
            ]
        out.append(make_sentence(",".join(fields)))
    return out


def gsv_glonass(world, sky: dict[int, "object"],
                cn0_dbhz: dict[int, float] | None = None,
                talker: str = "GL") -> list[str]:
    """GLGSV sentences for predicted GLONASS satellites (NMEA ids 65-96 =
    slot + 64; channels whose slot is not yet decoded are skipped)."""
    entries = []
    for p, s in sorted(sky.items()):
        if not (201 <= p <= 214) or s.elevation_deg <= 0.0:
            continue
        nid = nmea_sat_id(world, p)
        if nid is None:
            continue
        entries.append((nid, s, (cn0_dbhz or {}).get(p)))
    if not entries:
        return []
    n_msgs = (len(entries) + 3) // 4
    out = []
    for m in range(n_msgs):
        fields = [f"{talker}GSV", str(n_msgs), str(m + 1), f"{len(entries):02d}"]
        for nid, s, snr in entries[m * 4 : m * 4 + 4]:
            fields += [
                f"{nid:02d}",
                f"{int(round(s.elevation_deg)):02d}",
                f"{int(round(s.azimuth_deg)) % 360:03d}",
                f"{int(round(snr)):02d}" if snr is not None else "",
            ]
        out.append(make_sentence(",".join(fields)))
    return out


def sentences_for_fix(
    world, fix: "ReceiverSolution", include_gsv: bool = True, talker: str = "GP"
) -> list[str]:
    """The full per-fix sentence burst (GGA, GSA, RMC, VTG, [GSV...], ZDA).

    Multi-constellation fixes (any GLONASS satellite used) follow the
    NMEA 4.10 convention: the GN talker for the position sentences, one
    GSA per system (system id 1 GPS / 2 GLONASS, GLONASS satellites as
    slot+64), and per-constellation GPGSV/GLGSV."""
    when = utc_of_fix(world, fix)
    if when is None:
        return []
    glo_used = [p for p in fix.satellites_used if 201 <= p <= 214]
    if glo_used and talker == "GP":
        talker = "GN"
    out = [gga(fix, when, talker)]
    if glo_used:
        gps_ids = [
            nmea_sat_id(world, p) or p
            for p in fix.satellites_used if p < 200
        ]
        glo_ids = [
            i for i in (nmea_sat_id(world, p) for p in glo_used)
            if i is not None
        ]
        if gps_ids:
            out.append(gsa(fix, talker, sat_ids=gps_ids, system_id=1))
        out.append(gsa(fix, talker, sat_ids=glo_ids, system_id=2))
    else:
        out.append(gsa(fix, talker))
    out += [rmc(fix, when, talker), vtg(fix, talker)]
    if include_gsv:
        sky = world.predicted_sky(fix.receiver_timestamp, fix.ecef)
        cn0 = {
            p: r.cn0_dbhz
            for p, r in world._sats.items()
            if r.cn0_dbhz is not None
        }
        out.extend(gsv(sky, cn0, "GP" if talker == "GN" else talker))
        out.extend(gsv_glonass(world, sky, cn0))
    out.append(zda(when, talker))
    return out


class NmeaWriter:
    """Block listener (runtime/receiver.py:add_block_listener) that renders
    a sentence burst for every published fix. With ``path`` the stream is
    written incrementally (line-buffered, the live-consumer contract NMEA
    exists for); ``write`` dumps the accumulated log either way."""

    def __init__(self, path: str | None = None, include_gsv: bool = True,
                 talker: str = "GP") -> None:
        self.lines: list[str] = []
        self.include_gsv = include_gsv
        self.talker = talker
        self._fh = open(path, "w") if path else None
        self._n_fixes = 0

    def on_block(self, recv, report) -> None:
        if report.fix is None:
            return
        burst = sentences_for_fix(
            recv.world, report.fix, self.include_gsv, self.talker
        )
        if not burst:
            return
        self._n_fixes += 1
        self.lines.extend(burst)
        if self._fh is not None:
            self._fh.write("".join(line + "\r\n" for line in burst))
            self._fh.flush()

    @property
    def n_fixes(self) -> int:
        return self._n_fixes

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("".join(line + "\r\n" for line in self.lines))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# Parsing (round-trip test surface; GGA + RMC cover position/time/velocity)


@dataclass(frozen=True)
class GgaFix:
    utc_seconds: float  # seconds into the UTC day
    lat_deg: float
    lon_deg: float
    quality: int
    n_satellites: int
    hdop: float | None
    alt_m: float


@dataclass(frozen=True)
class RmcFix:
    when: _dt.datetime
    status: str
    lat_deg: float
    lon_deg: float
    speed_mps: float | None
    course_deg: float | None
    mode: str


def _split_checked(sentence: str, kind: str) -> list[str]:
    s = sentence.strip()
    if not s.startswith("$") or "*" not in s:
        raise ValueError(f"not an NMEA sentence: {s!r}")
    body, cs = s[1:].rsplit("*", 1)
    if checksum(body) != cs.upper():
        raise ValueError(f"checksum mismatch in {s!r}")
    fields = body.split(",")
    if fields[0][2:] != kind:
        raise ValueError(f"expected {kind}, got {fields[0]!r}")
    return fields


def parse_gga(sentence: str) -> GgaFix:
    f = _split_checked(sentence, "GGA")
    t = f[1]
    utc_s = int(t[0:2]) * 3600 + int(t[2:4]) * 60 + float(t[4:])
    return GgaFix(
        utc_seconds=utc_s,
        lat_deg=_parse_angle(f[2], f[3]),
        lon_deg=_parse_angle(f[4], f[5]),
        quality=int(f[6]),
        n_satellites=int(f[7]),
        hdop=float(f[8]) if f[8] else None,
        alt_m=float(f[9]),
    )


def parse_rmc(sentence: str) -> RmcFix:
    f = _split_checked(sentence, "RMC")
    t, d = f[1], f[9]
    when = _dt.datetime(
        2000 + int(d[4:6]), int(d[2:4]), int(d[0:2]),
        int(t[0:2]), int(t[2:4]),
    ) + _dt.timedelta(seconds=float(t[4:]))
    return RmcFix(
        when=when,
        status=f[2],
        lat_deg=_parse_angle(f[3], f[4]),
        lon_deg=_parse_angle(f[5], f[6]),
        speed_mps=float(f[7]) / _KNOTS_PER_MPS if f[7] else None,
        course_deg=float(f[8]) if f[8] else None,
        mode=f[12] if len(f) > 12 else "",
    )
