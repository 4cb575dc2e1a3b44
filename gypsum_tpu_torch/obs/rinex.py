"""RINEX 3.04 export (observation + navigation) and a matching reader.

Interoperability with the wider GNSS ecosystem (RTKLIB, gLAB, teqc-era
toolchains): the receiver's raw observables — pseudorange, accumulated
carrier phase, Doppler, C/N0 — stream into a standard OBS file, and decoded
broadcast ephemerides into a NAV file. The reference receiver has no export
of any kind (observables die inside its world model).

Conventions
-----------
- Epochs are GPS time (stream time + the receiver clock slide), one epoch
  per tracking block. No leap-second handling is needed: RINEX GPS-time
  files are tagged in GPS time.
- C1C: the solver's full pseudorange, c * (slide + arrival - sv_tow) —
  RAW in the RINEX sense (no atmospheric or SBAS corrections applied).
- L1C: accumulated carrier in cycles with the RINEX sign (grows with
  range), i.e. MINUS the tracker's NCO cycles (solve/rtk.py reconstructs
  those exactly); arbitrary integer offset per arc, loss-of-lock flagged
  via a new arc.
- D1C: tracker Doppler (positive while approaching — already the RINEX
  convention).
- S1C: the per-block M2M4 C/N0 estimate (obs/cn0.py).

The writer emits structurally strict RINEX (60-character content field +
20-character header labels, 16-character observation cells); the reader
round-trips everything the writer produces and is deliberately limited to
that subset.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass, field

import numpy as np

from gypsum_tpu_torch.core.constants import SPEED_OF_LIGHT_M_PER_S as C

#: GPS time zero.
GPS_EPOCH = _dt.datetime(1980, 1, 6, 0, 0, 0)

OBS_TYPES = ("C1C", "L1C", "D1C", "S1C")
# GLONASS rows: L1C is omitted — the FDMA tracker NCO replays offset-
# RELATIVE phase (the k * 562.5 kHz sub-band carrier is wiped separately),
# so the exact host phase reconstruction (solve/rtk.py:CarrierPhaseLog)
# does not apply; C2C is the L2OF pseudorange, reconstructed as
# C1C + c * wrap(d_L2 - d_L1) from the dual-frequency band
# (solve/world_multiconstellation.py) — external tools can form their own
# iono-free/geometry-free combinations from the pair.
OBS_TYPES_R = ("C1C", "D1C", "S1C", "C2C")
OBS_TYPES_BY_SYS = {"G": OBS_TYPES, "S": OBS_TYPES, "R": OBS_TYPES_R}


def _gps_datetime(week: int, sow: float) -> _dt.datetime:
    return GPS_EPOCH + _dt.timedelta(weeks=week, seconds=float(sow))


def _hline(content: str, label: str) -> str:
    return f"{content:<60.60s}{label:<20.20s}".rstrip() + "\n"


def _sys_of(prn: int) -> tuple[str, int]:
    """RINEX system letter + in-system number: GPS G01-G32, SBAS S20-S38
    (SBAS PRN 120-138 -> S(prn-100))."""
    if 1 <= prn <= 32:
        return "G", prn
    if 120 <= prn <= 138:
        return "S", prn - 100
    raise ValueError(f"PRN {prn} not representable in RINEX")


# --------------------------------------------------------------------------
# Observation writer
# --------------------------------------------------------------------------


@dataclass
class _EpochRow:
    prn: int
    c1c: float | None
    l1c: float | None
    d1c: float | None
    s1c: float | None
    new_arc: bool
    # RINEX identity: GPS G01-32 / SBAS S20-38 keep prn-derived numbers;
    # GLONASS rows are numbered by ORBITAL SLOT (string 4), with the
    # slot -> frequency-number map emitted as the GLONASS SLOT / FRQ #
    # header (the channel id 201..214 is a frequency, not a RINEX number).
    sys: str = "G"
    num: int = 0
    c2c: float | None = None


class RinexObsWriter:
    """Collects per-epoch observables; ``write()`` renders the file.

    Attach to a receiver with ``receiver.add_block_listener(writer.on_block)``
    — it reconstructs carrier phase with a CarrierPhaseLog and pulls
    pseudoranges from the world model's tick state at each processed block's
    end.
    """

    def __init__(self, receiver, marker: str = "GYPSUM") -> None:
        from gypsum_tpu_torch.solve.rtk import CarrierPhaseLog

        self._recv = receiver
        self.marker = marker
        self._phase = CarrierPhaseLog(
            receiver.sample_rate, receiver.samples_per_prn,
            receiver.config.tracking,
        )
        self._arc_count: dict[int, int] = {}
        self.epochs: list[tuple[float, list[_EpochRow]]] = []  # (sow, rows)
        self.week: int | None = None
        self.slot_to_freq: dict[int, int] = {}  # GLONASS SLOT / FRQ # header

    # ------------------------------------------------------------ ingest

    def on_block(self, recv, report) -> None:
        world = recv.world
        if world.receiver_clock_slide is None or not report.observations:
            return
        rows: list[_EpochRow] = []
        sow = None
        for obs in report.observations:
            rec = world._sats.get(obs.prn)
            glonass = rec is not None and rec.glonass is not None
            if not glonass:
                self._phase.ingest(obs)
            # Pseudoranges need the tick time base AND the SV clock model
            # (ephemeris / MT9 / GLONASS strings), so export starts once
            # the orbit is decoded (~18 s into a cold start, immediately
            # on a warm one).
            if (rec is None or not rec.counting
                    or rec.tow_at_last_subframe is None or not rec.has_orbit
                    or rec.glonass_ghost):
                continue
            t_end = float(obs.start_times[0]) - float(obs.code_phases[0]) / recv.sample_rate
            t_end += obs.start_times.shape[0] * 1e-3
            sow = world.receiver_clock_slide + t_end
            delay = rec.smoothed_delay_s if rec.smoothed_delay_s is not None else (
                ((rec.code_phase_delay_s + 0.5e-3) % 1e-3) - 0.5e-3
            )
            # RAW pseudorange: the per-system receiver clock stays in (the
            # GPS-GLONASS inter-system bias is NOT removed — consumers
            # estimate per-system clocks, the RINEX convention).
            pr = C * ((world.receiver_clock_slide + t_end + delay)
                      - world.observed_sv_time_of_week(obs.prn))
            if glonass:
                slot = int(rec.glonass.slot)
                if slot < 1:
                    continue  # R numbers are orbital slots (string 4)
                self.slot_to_freq[slot] = int(rec.glonass.frequency_number)
                c2c = None
                if rec.l2_delay_s is not None and rec.l2_updated_at is not None:
                    d2 = ((rec.l2_delay_s - delay + 0.5e-3) % 1e-3) - 0.5e-3
                    c2c = pr + C * d2
                rows.append(_EpochRow(
                    prn=obs.prn, c1c=pr, l1c=None,
                    d1c=float(obs.dopplers[-1]),
                    s1c=rec.cn0_dbhz, new_arc=False,
                    sys="R", num=slot, c2c=c2c,
                ))
                continue
            arcs = self._phase.arcs.get(obs.prn, [])
            new_arc = len(arcs) != self._arc_count.get(obs.prn)
            self._arc_count[obs.prn] = len(arcs)
            l1c = None
            if arcs:
                # Propagate the last-ms phase to the block END (the
                # pseudorange epoch) along its own Doppler; RINEX sign:
                # phase grows with range.
                l1c = -(arcs[-1].phase_cycles[-1]
                        + float(obs.dopplers[-1]) * 1e-3)
            sys_l, num = _sys_of(obs.prn)
            rows.append(_EpochRow(
                prn=obs.prn, c1c=pr, l1c=l1c,
                d1c=float(obs.dopplers[-1]),
                s1c=rec.cn0_dbhz, new_arc=new_arc,
                sys=sys_l, num=num,
            ))
        if rows and sow is not None:
            if self.week is None:
                self.week = self._week_from_world(world)
            self.epochs.append((sow, rows))

    @staticmethod
    def _week_from_world(world) -> int | None:
        for rec in world._sats.values():
            if rec.ephemeris is not None:
                return int(rec.ephemeris.week_number) + int(
                    world.config.gps_epoch_base_week_number
                )
        return None

    # ------------------------------------------------------------- render

    def render(self, approx_ecef: np.ndarray | None = None) -> str:
        return render_obs_merged([self], approx_ecef=approx_ecef)

    def write(self, path: str, approx_ecef: np.ndarray | None = None) -> None:
        with open(path, "w") as f:
            f.write(self.render(approx_ecef))


def _sys_num_of_row(r: _EpochRow) -> tuple[str, int]:
    """Explicit (sys, num) when set (GLONASS rows carry their slot);
    prn-derived otherwise (also keeps pre-existing hand-built rows valid)."""
    if r.num:
        return r.sys, r.num
    return _sys_of(r.prn)


def _row_cells(r: _EpochRow, sys_l: str) -> list[str]:
    cells = []
    vals = {"C1C": r.c1c, "L1C": r.l1c, "D1C": r.d1c, "S1C": r.s1c,
            "C2C": r.c2c}
    for t in OBS_TYPES_BY_SYS[sys_l]:
        v = vals[t]
        if v is None:
            cells.append(" " * 16)
        else:
            lli = "1" if (t == "L1C" and r.new_arc) else " "
            cells.append(f"{v:14.3f}{lli}" + " ")
    return cells


def render_obs_merged(
    writers: "list[RinexObsWriter]", approx_ecef: np.ndarray | None = None
) -> str:
    """One RINEX OBS file from one writer per band (a DualBandReceiver
    attaches a writer to each Receiver): epochs from different bands land
    on the same receiver timeline (lockstep blocks), so rows are merged by
    millisecond-rounded epoch."""
    merged: dict[int, tuple[float, list[_EpochRow]]] = {}
    for w in writers:
        for sow, rows in w.epochs:
            key = int(round(sow * 1e3))
            if key in merged:
                merged[key][1].extend(rows)
            else:
                merged[key] = (sow, list(rows))
    if not merged:
        raise ValueError("no epochs recorded")
    epochs = [merged[k] for k in sorted(merged)]
    week = next((w.week for w in writers if w.week is not None), 2298)
    slot_to_freq: dict[int, int] = {}
    for w in writers:
        slot_to_freq.update(getattr(w, "slot_to_freq", {}))
    marker = writers[0].marker
    systems = sorted({_sys_num_of_row(r)[0] for _, rows in epochs for r in rows})
    first = _gps_datetime(week, epochs[0][0])
    now = first.strftime("%Y%m%d %H%M%S GPS")

    out = []
    sys_desc = {"G": "G: GPS", "S": "S: SBAS payload", "R": "R: GLONASS"}
    desc = "M: MIXED" if len(systems) > 1 else sys_desc[systems[0]]
    out.append(_hline(f"{3.04:9.2f}{'':11s}{'OBSERVATION DATA':<20s}{desc}",
                      "RINEX VERSION / TYPE"))
    out.append(_hline(f"{'gypsum-tpu':<20s}{'':20s}{now:<20s}", "PGM / RUN BY / DATE"))
    out.append(_hline(f"{marker:<60s}", "MARKER NAME"))
    out.append(_hline(f"{'gypsum':<20s}{'gypsum-tpu':<40s}", "OBSERVER / AGENCY"))
    out.append(_hline(f"{'0':<20s}{'SDR':<20s}{'1':<20s}", "REC # / TYPE / VERS"))
    out.append(_hline(f"{'0':<20s}{'NONE':<20s}", "ANT # / TYPE"))
    pos = np.zeros(3) if approx_ecef is None else np.asarray(approx_ecef)
    out.append(_hline(f"{pos[0]:14.4f}{pos[1]:14.4f}{pos[2]:14.4f}",
                      "APPROX POSITION XYZ"))
    out.append(_hline(f"{0.0:14.4f}{0.0:14.4f}{0.0:14.4f}", "ANTENNA: DELTA H/E/N"))
    for sys_l in systems:
        types_s = OBS_TYPES_BY_SYS[sys_l]
        types = "".join(f" {t}" for t in types_s)
        out.append(_hline(f"{sys_l}  {len(types_s):3d}{types}", "SYS / # / OBS TYPES"))
    if "R" in systems and slot_to_freq:
        slots = sorted(slot_to_freq)
        line = f"{len(slots):3d}"
        for j, slot in enumerate(slots):
            if j and j % 8 == 0:
                out.append(_hline(line, "GLONASS SLOT / FRQ #"))
                line = "   "
            line += f" R{slot:02d} {slot_to_freq[slot]:2d}"
        out.append(_hline(line, "GLONASS SLOT / FRQ #"))
    out.append(_hline(
        f"{first.year:6d}{first.month:6d}{first.day:6d}{first.hour:6d}"
        f"{first.minute:6d}{first.second + first.microsecond / 1e6:13.7f}"
        f"{'':5s}{'GPS':<3s}", "TIME OF FIRST OBS"))
    out.append(_hline("", "END OF HEADER"))

    for sow, rows in epochs:
        # Round to the written precision FIRST so the calendar fields and
        # the seconds cell cannot disagree at a minute boundary.
        sow = round(sow * 1e7) / 1e7
        dt = _gps_datetime(week, sow)
        sec = sow % 60.0
        out.append(f"> {dt.year:4d} {dt.month:02d} {dt.day:02d} "
                   f"{dt.hour:02d} {dt.minute:02d}{sec:11.7f}  0"
                   f"{len(rows):3d}\n")
        for r in sorted(rows, key=_sys_num_of_row):
            sys_l, num = _sys_num_of_row(r)
            out.append(
                f"{sys_l}{num:02d}" + "".join(_row_cells(r, sys_l)).rstrip() + "\n"
            )
    return "".join(out)


def write_obs_merged(
    path: str,
    writers: "list[RinexObsWriter]",
    approx_ecef: np.ndarray | None = None,
) -> int:
    """Write the merged OBS file; returns the epoch count."""
    text = render_obs_merged(writers, approx_ecef=approx_ecef)
    with open(path, "w") as f:
        f.write(text)
    return sum(1 for line in text.splitlines() if line.startswith("> "))


# --------------------------------------------------------------------------
# Navigation writer
# --------------------------------------------------------------------------

_NAV_FIELDS = (
    # line 1 (after the epoch/clock line prefix): handled separately
    ("iode", "crs", "delta_n", "m0"),
    ("cuc", "eccentricity", "cus", "sqrt_a"),
    ("t_oe", "cic", "omega0", "cis"),
    ("i0", "crc", "omega", "omega_dot"),
    ("idot", "l2_codes", "week_eff", "l2p_flag"),
    ("sv_accuracy", "sv_health", "t_gd", "iodc"),
    ("transmit_time", "fit_interval", "spare1", "spare2"),
)


def render_nav(
    ephemerides: dict[int, "object"],
    base_week: int = 2048,
    glonass: "dict[int, object] | None" = None,
    glonass_utc_day0: "_dt.datetime | None" = None,
) -> str:
    """RINEX 3.04 navigation file from decoded ephemerides: GPS records,
    plus GLONASS state-vector records (``glonass``: GlonassEphemeris by any
    key; written as R<slot>) in a MIXED file when both are present.
    ``parse_nav`` reads back the G records, ``parse_nav_glonass`` the R
    records — each skips the other system."""
    sys_desc = (
        "M: MIXED" if (glonass and ephemerides)
        else ("R: GLONASS" if glonass else "G: GPS")
    )
    out = [
        _hline(f"{3.04:9.2f}{'':11s}{'N: GNSS NAV DATA':<20s}{sys_desc:<20s}",
               "RINEX VERSION / TYPE"),
        _hline(f"{'gypsum-tpu':<20s}{'':20s}{'':20s}", "PGM / RUN BY / DATE"),
        _hline("", "END OF HEADER"),
    ]
    if glonass:
        out.extend(_glonass_nav_records(glonass, glonass_utc_day0))

    def num(v: float) -> str:
        return f"{v:19.12E}"

    for prn in sorted(ephemerides):
        eph = ephemerides[prn]
        week = int(eph.week_number) + base_week
        toc = _gps_datetime(week, eph.t_oc)
        out.append(
            f"G{prn:02d} {toc.year:4d} {toc.month:02d} {toc.day:02d} "
            f"{toc.hour:02d} {toc.minute:02d} {toc.second:02d}"
            + num(eph.a_f0) + num(eph.a_f1) + num(eph.a_f2) + "\n"
        )
        vals = {
            "iode": 0.0, "crs": eph.crs, "delta_n": eph.delta_n, "m0": eph.m0,
            "cuc": eph.cuc, "eccentricity": eph.eccentricity, "cus": eph.cus,
            "sqrt_a": eph.sqrt_a,
            "t_oe": eph.t_oe, "cic": eph.cic, "omega0": eph.omega0, "cis": eph.cis,
            "i0": eph.i0, "crc": eph.crc, "omega": eph.omega,
            "omega_dot": eph.omega_dot,
            "idot": eph.idot, "l2_codes": 0.0, "week_eff": float(week),
            "l2p_flag": 0.0,
            "sv_accuracy": 2.0, "sv_health": 0.0, "t_gd": eph.t_gd, "iodc": 0.0,
            "transmit_time": eph.t_oe, "fit_interval": 4.0,
            "spare1": 0.0, "spare2": 0.0,
        }
        for line_fields in _NAV_FIELDS:
            out.append("    " + "".join(num(vals[f]) for f in line_fields) + "\n")
    return "".join(out)


#: Fallback UTC day for GLONASS nav records: the broadcast day number n_t
#: counts within a 4-year cycle whose calendar origin the receiver cannot
#: know from the strings alone, and the record's UTC date is informational
#: for this framework's synthetic scenes — what round-trips is the within-
#: day tb, the state vector, tau/gamma, and the frequency number.
_GLONASS_DAY0 = _dt.datetime(2024, 1, 1)


def render_nav_glonass(
    ephemerides: "dict[int, object]",
    utc_day0: _dt.datetime | None = None,
) -> str:
    """RINEX 3.04 GLONASS navigation file from decoded string-1..4
    ephemerides (solve/glonass.py:GlonassEphemeris), keyed by channel id
    201-214 or by slot — records are written as R<slot>. Units per the
    spec: km, km/s, km/s^2; clock line is -tau_n, +gamma_n, message frame
    time; body lines carry health (Bn), frequency number, and age."""
    out = [
        _hline(f"{3.04:9.2f}{'':11s}{'N: GNSS NAV DATA':<20s}{'R: GLONASS':<20s}",
               "RINEX VERSION / TYPE"),
        _hline(f"{'gypsum-tpu':<20s}{'':20s}{'':20s}", "PGM / RUN BY / DATE"),
        _hline("", "END OF HEADER"),
    ]
    out.extend(_glonass_nav_records(ephemerides, utc_day0))
    return "".join(out)


def _glonass_nav_records(
    ephemerides: "dict[int, object]", utc_day0: _dt.datetime | None
) -> list[str]:
    day0 = utc_day0 or _GLONASS_DAY0
    out: list[str] = []

    def num(v: float) -> str:
        return f"{v:19.12E}"

    for key in sorted(ephemerides):
        eph = ephemerides[key]
        slot = int(eph.slot)
        if slot < 1:
            continue
        # tb is Moscow (UTC+3h) day time; the record epoch is UTC.
        utc = day0 + _dt.timedelta(seconds=float(eph.tb_day_s) - 10800.0)
        out.append(
            f"R{slot:02d} {utc.year:4d} {utc.month:02d} {utc.day:02d} "
            f"{utc.hour:02d} {utc.minute:02d} {utc.second:02d}"
            + num(-eph.tau_n_s) + num(eph.gamma_n)
            + num(float(eph.tb_day_s) - 10800.0) + "\n"
        )
        p_km = np.asarray(eph.pos_m) / 1e3
        v_kms = np.asarray(eph.vel_mps) / 1e3
        a_kms2 = np.asarray(eph.acc_mps2) / 1e3
        tail = (float(eph.health_bn), float(eph.frequency_number), 0.0)
        for axis in range(3):
            out.append(
                "    " + num(p_km[axis]) + num(v_kms[axis])
                + num(a_kms2[axis]) + num(tail[axis]) + "\n"
            )
    return out


def parse_nav_glonass(text: str) -> "dict[int, object]":
    """Read R records back into GlonassEphemeris, keyed by channel id
    201-214 (208 + frequency number) — the id every other GLONASS surface
    in this framework uses.

    External (IGS-style) nav files can legitimately contain ANTIPODAL
    satellites sharing one frequency number; this framework's channel-id
    model is one SV per frequency, so only one of the pair can be kept.
    When distinct slots collide on a frequency number, the later record
    overwrites the earlier one and a warning names both slots so the drop
    is not silent (round-trip of this framework's own files is unaffected).
    """
    import logging

    from gypsum_tpu_torch.solve.glonass import GlonassEphemeris

    logger = logging.getLogger(__name__)

    lines = text.splitlines()
    i = 0
    while i < len(lines) and lines[i][60:].strip() != "END OF HEADER":
        i += 1
    i += 1
    out: dict[int, GlonassEphemeris] = {}
    while i < len(lines):
        head = lines[i]
        if not head.startswith("R") or i + 4 > len(lines):
            i += 1
            continue
        slot = int(head[1:3])
        utc = _dt.datetime(int(head[4:8]), int(head[9:11]), int(head[12:14]),
                           int(head[15:17]), int(head[18:20]), int(head[21:23]))
        neg_tau, gamma, _frame = (
            float(head[23 + 19 * k : 23 + 19 * (k + 1)]) for k in range(3)
        )
        body = []
        for j in range(3):
            row = lines[i + 1 + j][4:]
            body.append([float(row[19 * k : 19 * (k + 1)]) for k in range(4)])
        i += 4
        tb_day_s = ((utc - _dt.datetime(utc.year, utc.month, utc.day))
                    .total_seconds() + 10800.0) % 86400.0
        eph = GlonassEphemeris(
            frequency_number=int(round(body[1][3])),
            tb_day_s=tb_day_s,
            pos_m=np.array([body[a][0] for a in range(3)]) * 1e3,
            vel_mps=np.array([body[a][1] for a in range(3)]) * 1e3,
            acc_mps2=np.array([body[a][2] for a in range(3)]) * 1e3,
            tau_n_s=-neg_tau,
            gamma_n=gamma,
            slot=slot,
            health_bn=int(round(body[0][3])),
        )
        key = 208 + eph.frequency_number
        prev = out.get(key)
        if prev is not None and prev.slot != eph.slot:
            logger.warning(
                "GLONASS nav file: slots R%02d and R%02d share frequency "
                "number %+d (antipodal pair); keeping R%02d only — one SV "
                "per frequency channel in this receiver's id model",
                prev.slot, eph.slot, eph.frequency_number, eph.slot,
            )
        out[key] = eph
    return out


# --------------------------------------------------------------------------
# Readers (round-trip the writer's subset)
# --------------------------------------------------------------------------


@dataclass
class RinexObs:
    week: int | None
    obs_types: tuple[str, ...]
    epochs: list[tuple[_dt.datetime, dict[int, dict[str, float]]]] = field(
        default_factory=list
    )
    # Per-system observation type lists (obs_types keeps the GPS list for
    # backward compatibility) and the GLONASS slot -> frequency-number map.
    obs_types_by_sys: dict[str, tuple[str, ...]] = field(default_factory=dict)
    slot_to_freq: dict[int, int] = field(default_factory=dict)


def parse_obs(text: str) -> RinexObs:
    """Rows key satellites by this framework's internal ids: GPS 1-32,
    SBAS 120-138, GLONASS 201-214 (frequency-channel ids, mapped from the
    file's R<slot> numbers via the GLONASS SLOT / FRQ # header)."""
    lines = text.splitlines()
    i = 0
    obs_types: tuple[str, ...] = ()
    by_sys: dict[str, tuple[str, ...]] = {}
    slot_to_freq: dict[int, int] = {}
    while i < len(lines):
        line = lines[i]
        label = line[60:].strip()
        if label == "SYS / # / OBS TYPES":
            sys_l = line[0]
            by_sys[sys_l] = tuple(line[7:60].split())
            if not obs_types or sys_l == "G":
                obs_types = by_sys[sys_l]
        if label == "GLONASS SLOT / FRQ #":
            toks = line[3:60].split()
            for j in range(0, len(toks) - 1, 2):
                if toks[j].startswith("R"):
                    slot_to_freq[int(toks[j][1:])] = int(toks[j + 1])
        if label == "END OF HEADER":
            i += 1
            break
        i += 1
    result = RinexObs(
        week=None, obs_types=obs_types, obs_types_by_sys=by_sys,
        slot_to_freq=slot_to_freq,
    )
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.startswith("> "):
            continue
        y, mo, d, h, mi = (int(line[2:6]), int(line[7:9]), int(line[10:12]),
                           int(line[13:15]), int(line[16:18]))
        sec = float(line[18:30])
        n = int(line[32:36])
        when = _dt.datetime(y, mo, d, h, mi) + _dt.timedelta(seconds=sec)
        rows: dict[int, dict[str, float]] = {}
        for _ in range(n):
            rec = lines[i]
            i += 1
            sys_l, num = rec[0], int(rec[1:3])
            if sys_l == "G":
                prn = num
            elif sys_l == "S":
                prn = num + 100
            elif sys_l == "R":
                if num not in slot_to_freq:
                    continue  # unmapped slot: cannot identify the channel
                prn = 208 + slot_to_freq[num]
            else:
                continue
            types = by_sys.get(sys_l, obs_types)
            vals = {}
            for k, t in enumerate(types):
                cell = rec[3 + 16 * k : 3 + 16 * (k + 1)]
                if cell[:14].strip():
                    vals[t] = float(cell[:14])
                    if t == "L1C" and len(cell) > 14 and cell[14] == "1":
                        vals["L1C_slip"] = 1.0
            rows[prn] = vals
        result.epochs.append((when, rows))
    return result


def parse_nav(text: str) -> dict[int, "object"]:
    from gypsum_tpu_torch.solve.ephemeris import Ephemeris

    lines = text.splitlines()
    i = 0
    while i < len(lines) and lines[i][60:].strip() != "END OF HEADER":
        i += 1
    i += 1
    out: dict[int, Ephemeris] = {}
    while i < len(lines):
        head = lines[i]
        if not head.startswith("G") or i + 8 > len(lines):
            i += 1
            continue
        prn = int(head[1:3])
        toc = _dt.datetime(int(head[4:8]), int(head[9:11]), int(head[12:14]),
                           int(head[15:17]), int(head[18:20]), int(head[21:23]))
        a_f0, a_f1, a_f2 = (float(head[23 + 19 * k : 23 + 19 * (k + 1)])
                            for k in range(3))
        vals = []
        for j in range(7):
            body = lines[i + 1 + j][4:]
            vals.extend(float(body[19 * k : 19 * (k + 1)]) for k in range(4))
        i += 8
        names = [f for line_fields in _NAV_FIELDS for f in line_fields]
        v = dict(zip(names, vals))
        week_eff = int(v["week_eff"])
        gps_dt = toc - GPS_EPOCH
        t_oc = gps_dt.total_seconds() - week_eff * 7 * 86400.0
        out[prn] = Ephemeris(
            sqrt_a=v["sqrt_a"], eccentricity=v["eccentricity"], i0=v["i0"],
            omega0=v["omega0"], omega=v["omega"], m0=v["m0"],
            delta_n=v["delta_n"], idot=v["idot"], omega_dot=v["omega_dot"],
            cuc=v["cuc"], cus=v["cus"], crc=v["crc"], crs=v["crs"],
            cic=v["cic"], cis=v["cis"], t_oe=v["t_oe"],
            a_f0=a_f0, a_f1=a_f1, a_f2=a_f2, t_oc=t_oc, t_gd=v["t_gd"],
            week_number=week_eff,
        )
    return out
