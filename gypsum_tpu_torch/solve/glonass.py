"""GLONASS broadcast ephemeris: state-vector orbits, clocks, time scales.

Unlike GPS's Keplerian element set (solve/ephemeris.py), a GLONASS
ephemeris is an ECEF state vector (position, velocity, lunisolar
acceleration) at a reference time t_b within the GLONASS day, propagated by
numerically integrating the equations of motion in the rotating PZ-90 frame
with the central + J2 gravity field (GLONASS ICD §A.3.1.2); broadcast
validity is +/-15 min around t_b. PZ-90.11 agrees with WGS84 to
centimeters, so positions feed the WGS84 solver unchanged.

Integration: classic RK4 at a fixed step (default 30 s, final partial
step), matching standard receiver practice; tests pin forward/backward
reversibility and agreement with an independent adaptive integrator.

Clock (ICD §4.8): t_GLONASS = t_sv + tau_n - gamma_n (t - t_b), so the SV
clock runs AHEAD of GLONASS time by gamma_n (t - t_b) - tau_n — the same
"ahead" convention solve/ephemeris.py:clock_correction uses for GPS.

Time scales: GLONASS time = UTC(SU) + 3 h (no leap-second offset: GLONASS
follows UTC through leap seconds); GPS time = UTC + leap seconds. The
helpers below map GLONASS day-time to GPS seconds-of-week given the leap
count; the residual sub-microsecond GPS-GLONASS offset (hardware biases +
the broadcast-level tau_GPS) is NOT assumed known — the multi-constellation
fix solves it as a per-constellation clock unknown (solve/fix.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GLONASS_L1_BASE_HZ,
    GLONASS_L1_CHANNEL_SPACING_HZ,
    PZ90_EARTH_RADIUS_M,
    PZ90_EARTH_ROTATION_RATE_RAD_PER_S,
    PZ90_J2,
    PZ90_MU,
)
from gypsum_tpu_torch.nav.glonass import GlonassString

GLONASS_UTC_OFFSET_S = 3 * 3600  # GLONASS time = UTC(SU) + 3 h (ICD §3.3.3)


@dataclass(frozen=True)
class GlonassEphemeris:
    """Broadcast state-vector ephemeris (strings 1-4)."""

    frequency_number: int  # FDMA k, -7..+6
    tb_day_s: float  # reference time within the GLONASS day (s)
    pos_m: tuple[float, float, float]  # PZ-90 ECEF at tb
    vel_mps: tuple[float, float, float]
    acc_mps2: tuple[float, float, float]  # lunisolar acceleration (constant)
    tau_n_s: float = 0.0  # SV clock offset at tb
    gamma_n: float = 0.0  # SV relative frequency offset
    slot: int = 0  # orbital slot n (string 4); 0 = unknown
    health_bn: int = 0  # Bn (string 2); MSB set = unhealthy
    n_t: int = 0  # day number within the 4-year cycle (string 4)

    @property
    def carrier_frequency_hz(self) -> float:
        return GLONASS_L1_BASE_HZ + self.frequency_number * GLONASS_L1_CHANNEL_SPACING_HZ


def _acceleration(state: np.ndarray, acc_ls: np.ndarray) -> np.ndarray:
    """d/dt [x, y, z, vx, vy, vz] in the rotating PZ-90 frame (ICD A.3.1.2):
    central + J2 gravity, centrifugal + Coriolis, lunisolar term."""
    x, y, z, vx, vy, vz = state
    r2 = x * x + y * y + z * z
    r = np.sqrt(r2)
    mu_r3 = PZ90_MU / (r2 * r)
    c = 1.5 * PZ90_J2 * PZ90_MU * PZ90_EARTH_RADIUS_M**2 / (r2 * r2 * r)
    z2_r2 = z * z / r2
    w = PZ90_EARTH_ROTATION_RATE_RAD_PER_S
    ax = -mu_r3 * x - c * x * (1.0 - 5.0 * z2_r2) + w * w * x + 2.0 * w * vy + acc_ls[0]
    ay = -mu_r3 * y - c * y * (1.0 - 5.0 * z2_r2) + w * w * y - 2.0 * w * vx + acc_ls[1]
    az = -mu_r3 * z - c * z * (3.0 - 5.0 * z2_r2) + acc_ls[2]
    return np.array([vx, vy, vz, ax, ay, az])


def propagate_state(
    eph: GlonassEphemeris, t_day_s: float, step_s: float = 30.0
) -> tuple[np.ndarray, np.ndarray]:
    """(position [3] m, velocity [3] m/s) at GLONASS day-time ``t_day_s``,
    RK4-integrated from tb (either direction). Vectorized over a scalar or
    array ``t_day_s`` is NOT supported here — see positions() for grids."""
    state = np.array([*eph.pos_m, *eph.vel_mps], dtype=np.float64)
    acc_ls = np.asarray(eph.acc_mps2, dtype=np.float64)
    dt_total = float(t_day_s) - eph.tb_day_s
    n_full, rem = divmod(abs(dt_total), step_s)
    sign = 1.0 if dt_total >= 0 else -1.0
    steps = [sign * step_s] * int(n_full)
    if rem > 1e-12:
        steps.append(sign * rem)
    for h in steps:
        k1 = _acceleration(state, acc_ls)
        k2 = _acceleration(state + 0.5 * h * k1, acc_ls)
        k3 = _acceleration(state + 0.5 * h * k2, acc_ls)
        k4 = _acceleration(state + h * k3, acc_ls)
        state = state + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return state[:3].copy(), state[3:].copy()


def glonass_satellite_position(
    eph: GlonassEphemeris, t_day_s, step_s: float = 30.0
) -> np.ndarray:
    """ECEF position at scalar or array ``t_day_s`` ([3] or [N, 3] m)."""
    t = np.asarray(t_day_s, dtype=np.float64)
    if t.ndim == 0:
        return propagate_state(eph, float(t), step_s)[0]
    return np.stack([propagate_state(eph, float(ti), step_s)[0] for ti in t])


def glonass_satellite_velocity(
    eph: GlonassEphemeris, t_day_s: float, step_s: float = 30.0
) -> np.ndarray:
    return propagate_state(eph, float(t_day_s), step_s)[1]


def glonass_clock_ahead_s(eph: GlonassEphemeris, t_day_s) -> np.ndarray | float:
    """How far the SV clock runs AHEAD of GLONASS time at ``t_day_s``
    (ICD §4.8 rearranged): gamma_n (t - tb) - tau_n."""
    t = np.asarray(t_day_s, dtype=np.float64)
    return eph.gamma_n * (t - eph.tb_day_s) - eph.tau_n_s


# ------------------------------------------------------- string conversion


def strings_from_glonass_ephemeris(eph: GlonassEphemeris) -> dict[int, GlonassString]:
    """Strings 1-4 broadcasting this ephemeris (string 1's tk is filled per
    frame by nav/glonass.py:frame_strings_for_ephemeris)."""
    def q(v: float, scale: float) -> int:
        return int(round(v / scale))

    s = GlonassString.SCALES
    if eph.tb_day_s % 900.0:
        raise ValueError("tb must be a multiple of 15 minutes")
    return {
        1: GlonassString(m=1, fields={
            "p1": 0,
            "tk_raw": 0,  # per-frame
            "xdot_raw": q(eph.vel_mps[0], s["xdot_raw"]),
            "xdotdot_raw": q(eph.acc_mps2[0], s["xdotdot_raw"]),
            "x_raw": q(eph.pos_m[0], s["x_raw"]),
        }),
        2: GlonassString(m=2, fields={
            "bn": eph.health_bn, "p2": 0,
            "tb_raw": int(round(eph.tb_day_s / 900.0)),
            "ydot_raw": q(eph.vel_mps[1], s["ydot_raw"]),
            "ydotdot_raw": q(eph.acc_mps2[1], s["ydotdot_raw"]),
            "y_raw": q(eph.pos_m[1], s["y_raw"]),
        }),
        3: GlonassString(m=3, fields={
            "p3": 0, "gamma_raw": q(eph.gamma_n, s["gamma_raw"]),
            "p": 0, "l_n": 0,
            "zdot_raw": q(eph.vel_mps[2], s["zdot_raw"]),
            "zdotdot_raw": q(eph.acc_mps2[2], s["zdotdot_raw"]),
            "z_raw": q(eph.pos_m[2], s["z_raw"]),
        }),
        4: GlonassString(m=4, fields={
            "tau_raw": q(eph.tau_n_s, s["tau_raw"]),
            "delta_tau_raw": 0, "e_n": 0, "p4": 0, "f_t": 4,
            "n_t": eph.n_t, "n_slot": eph.slot, "m_type": 1,
        }),
    }


def glonass_ephemeris_from_strings(
    s1: GlonassString, s2: GlonassString, s3: GlonassString, s4: GlonassString,
    frequency_number: int,
) -> GlonassEphemeris:
    """Assemble a broadcast ephemeris from one frame's strings 1-4.

    The frequency number comes from the RECEIVER (it knows which FDMA
    channel it tracked); strings carry the slot number, not k."""
    for s, m in ((s1, 1), (s2, 2), (s3, 3), (s4, 4)):
        if s.m != m:
            raise ValueError(f"expected string {m}, got {s.m}")
    return GlonassEphemeris(
        frequency_number=frequency_number,
        tb_day_s=s2.tb_seconds,
        pos_m=(s1.scaled("x_raw"), s2.scaled("y_raw"), s3.scaled("z_raw")),
        vel_mps=(s1.scaled("xdot_raw"), s2.scaled("ydot_raw"), s3.scaled("zdot_raw")),
        acc_mps2=(
            s1.scaled("xdotdot_raw"), s2.scaled("ydotdot_raw"), s3.scaled("zdotdot_raw"),
        ),
        tau_n_s=s4.scaled("tau_raw"),
        gamma_n=s3.scaled("gamma_raw"),
        slot=s4.fields["n_slot"],
        health_bn=s2.fields["bn"],
        n_t=s4.fields["n_t"],
    )


# ------------------------------------------------------------- time scales


def glonass_day_time_from_gps_sow(gps_sow: float, leap_seconds: int) -> float:
    """GLONASS time-of-day corresponding to a GPS seconds-of-week instant:
    UTC = GPS - leap; GLONASS = UTC + 3 h; reduce into the day."""
    return (gps_sow - leap_seconds + GLONASS_UTC_OFFSET_S) % 86400.0


def gps_sow_from_glonass_day_time(
    glonass_day_s: float, approx_gps_sow: float, leap_seconds: int
) -> float:
    """Invert the day-time mapping near ``approx_gps_sow`` (the receiver's
    own GPS-derived time, good to well under 12 h — the day ambiguity
    resolution margin)."""
    base = glonass_day_s + leap_seconds - GLONASS_UTC_OFFSET_S
    k = np.round((approx_gps_sow - base) / 86400.0)
    return float(base + 86400.0 * k)


# --------------------------------------------------------- scene building


def glonass_ephemeris_from_look(
    receiver_ecef: np.ndarray,
    elevation_deg: float,
    azimuth_deg: float,
    frequency_number: int,
    tb_day_s: float,
    heading_deg: float = 0.0,
    tau_n_s: float = 0.0,
    gamma_n: float = 0.0,
    slot: int = 0,
) -> GlonassEphemeris:
    """A physically consistent GLONASS state vector placed along a chosen
    look direction from the receiver (the GLONASS counterpart of the GPS
    demo ephemerides in signal/scenarios.py, built directly in state-vector
    space): position at the GLONASS orbit radius along (az, el), velocity of
    a circular inertial orbit through that point (direction set by
    ``heading_deg`` within the local tangent plane) expressed in the
    rotating frame. RK4-propagating this state IS the ground truth the
    receiver must recover."""
    from gypsum_tpu_torch.solve.geodesy import ecef_to_lla

    rx = np.asarray(receiver_ecef, dtype=np.float64)
    lat, lon, _ = ecef_to_lla(rx)
    lat, lon = np.deg2rad(lat), np.deg2rad(lon)
    e_hat = np.array([-np.sin(lon), np.cos(lon), 0.0])
    n_hat = np.array(
        [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)]
    )
    u_hat = np.array(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)]
    )
    el, az = np.deg2rad(elevation_deg), np.deg2rad(azimuth_deg)
    los = (
        np.cos(el) * (np.sin(az) * e_hat + np.cos(az) * n_hat) + np.sin(el) * u_hat
    )
    r_orbit = 25_508_000.0  # a ~ 19,100 km altitude
    # |rx + rho los| = r_orbit -> rho.
    b = 2.0 * float(rx @ los)
    c0 = float(rx @ rx) - r_orbit * r_orbit
    rho = (-b + np.sqrt(b * b - 4.0 * c0)) / 2.0
    pos = rx + rho * los
    r_hat = pos / np.linalg.norm(pos)
    # Tangential basis at the satellite; heading 0 = "local east" there.
    t1 = np.cross(np.array([0.0, 0.0, 1.0]), r_hat)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(r_hat, t1)
    h = np.deg2rad(heading_deg)
    v_inertial = np.sqrt(PZ90_MU / r_orbit) * (np.cos(h) * t1 + np.sin(h) * t2)
    omega = np.array([0.0, 0.0, PZ90_EARTH_ROTATION_RATE_RAD_PER_S])
    v_ecef = v_inertial - np.cross(omega, pos)
    # Quantize through the broadcast fields so truth == what's transmitted.
    strings = strings_from_glonass_ephemeris(GlonassEphemeris(
        frequency_number=frequency_number,
        tb_day_s=tb_day_s,
        pos_m=tuple(pos),
        vel_mps=tuple(v_ecef),
        acc_mps2=(1.9e-9 * 1024, -2.8e-9 * 1024, 0.9e-9 * 1024),
        tau_n_s=tau_n_s,
        gamma_n=gamma_n,
        slot=slot,
    ))
    return glonass_ephemeris_from_strings(
        strings[1], strings[2], strings[3], strings[4], frequency_number
    )
