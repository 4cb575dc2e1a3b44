"""Broadcast ephemeris: Kepler orbit propagation and SV clock correction.

Implements the IS-GPS-200 §20.3.3.4.3 user algorithm (Table 20-IV), the same
computation as the reference's world model (gypsum/world_model.py:379-487,
635-705) but:

- as pure functions over an immutable ``Ephemeris`` value (the reference
  threads a mutable 27-entry ParameterSet dict through every call);
- vectorized over time (numpy broadcasting) so the synthetic-signal generator
  can evaluate whole trajectories at once;
- with the SV clock polynomial implemented per the ICD:
  af0 + af1*(t-toc) + af2*(t-toc)^2. (The reference computes
  (af2*(t-toc))^2 — gypsum/world_model.py:701 — which mis-scales the af2 term;
  af2 is almost always 0 so its fixes never showed. Documented divergence.)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.constants import (
    EARTH_GRAVITATIONAL_PARAM,
    EARTH_ROTATION_RATE_RAD_PER_S,
    GPS_PI,
    RELATIVISTIC_CLOCK_CORRECTION_F,
    SECONDS_PER_HALF_WEEK,
    SECONDS_PER_WEEK,
)
from gypsum_tpu_torch.nav.subframes import Subframe1, Subframe2, Subframe3


@dataclass(frozen=True)
class Ephemeris:
    """One SV's broadcast orbit + clock model, in radians / SI units."""

    # Keplerian elements
    sqrt_a: float  # m^0.5
    eccentricity: float
    i0: float  # rad
    omega0: float  # rad — longitude of ascending node at week start
    omega: float  # rad — argument of perigee
    m0: float  # rad — mean anomaly at reference time
    # Perturbations
    delta_n: float  # rad/s
    idot: float  # rad/s
    omega_dot: float  # rad/s
    cuc: float
    cus: float
    crc: float
    crs: float
    cic: float
    cis: float
    t_oe: float  # s of week
    # Clock model
    a_f0: float
    a_f1: float
    a_f2: float
    t_oc: float
    t_gd: float
    week_number: int | None = None

    @property
    def semi_major_axis(self) -> float:
        return self.sqrt_a**2


def ephemeris_from_subframes(sf1: Subframe1, sf2: Subframe2, sf3: Subframe3) -> Ephemeris:
    """Assemble an Ephemeris from decoded subframes 1-3, applying the ICD's
    semicircle -> radian conversions (reference: gypsum/world_model.py:809-861)."""
    return Ephemeris(
        sqrt_a=sf2.sqrt_a,
        eccentricity=sf2.eccentricity,
        i0=sf3.i0 * GPS_PI,
        omega0=sf3.omega0 * GPS_PI,
        omega=sf3.omega * GPS_PI,
        m0=sf2.m0 * GPS_PI,
        delta_n=sf2.delta_n * GPS_PI,
        idot=sf3.idot * GPS_PI,
        omega_dot=sf3.omega_dot * GPS_PI,
        cuc=sf2.cuc,
        cus=sf2.cus,
        crc=sf3.crc,
        crs=sf2.crs,
        cic=sf3.cic,
        cis=sf3.cis,
        t_oe=sf2.t_oe,
        a_f0=sf1.a_f0,
        a_f1=sf1.a_f1,
        a_f2=sf1.a_f2,
        t_oc=sf1.t_oc,
        t_gd=sf1.t_gd,
        week_number=sf1.week_number_mod_1024,
    )


def subframes_from_ephemeris(
    eph: Ephemeris, iode: int = 87
) -> tuple[Subframe1, Subframe2, Subframe3]:
    """Inverse of ``ephemeris_from_subframes``: subframe payloads carrying
    this ephemeris in ICD units, quantized to transmitted precision. Used by
    the constellation synthesizer and test fixtures."""
    from gypsum_tpu_torch.nav.subframes import roundtrip_fields

    sf1 = Subframe1(
        week_number_mod_1024=eph.week_number or 0, ca_or_p_on_l2=1, ura_index=0,
        sv_health=0, issue_of_data_clock=iode, l2_p_data_flag=0,
        t_gd=eph.t_gd, t_oc=eph.t_oc, a_f2=eph.a_f2, a_f1=eph.a_f1, a_f0=eph.a_f0,
    )
    sf2 = Subframe2(
        issue_of_data_ephemeris=iode, crs=eph.crs,
        delta_n=eph.delta_n / GPS_PI, m0=eph.m0 / GPS_PI,
        cuc=eph.cuc, eccentricity=eph.eccentricity, cus=eph.cus,
        sqrt_a=eph.sqrt_a, t_oe=eph.t_oe, fit_interval_flag=0,
        age_of_data_offset=0,
    )
    sf3 = Subframe3(
        cic=eph.cic, omega0=eph.omega0 / GPS_PI, cis=eph.cis,
        i0=eph.i0 / GPS_PI, crc=eph.crc, omega=eph.omega / GPS_PI,
        omega_dot=eph.omega_dot / GPS_PI, issue_of_data_ephemeris=iode,
        idot=eph.idot / GPS_PI,
    )
    return roundtrip_fields(sf1), roundtrip_fields(sf2), roundtrip_fields(sf3)


def time_from_epoch(t_sow, epoch: float):
    """tk = t - t_epoch, wrapped into +/- half a week
    (IS-GPS-200 §20.3.3.4.3; reference: gypsum/world_model.py:433-441)."""
    tk = np.asarray(t_sow, dtype=np.float64) - epoch
    tk = np.where(tk > SECONDS_PER_HALF_WEEK, tk - SECONDS_PER_WEEK, tk)
    tk = np.where(tk < -SECONDS_PER_HALF_WEEK, tk + SECONDS_PER_WEEK, tk)
    return tk


def eccentric_anomaly(eph: Ephemeris, tk, iterations: int = 10):
    """Solve Kepler's equation M = E - e sin(E) by fixed point
    (reference uses 7 iterations, gypsum/world_model.py:403-407)."""
    n0 = np.sqrt(EARTH_GRAVITATIONAL_PARAM / eph.semi_major_axis**3)
    n = n0 + eph.delta_n
    m = eph.m0 + n * np.asarray(tk, dtype=np.float64)
    e_anom = m
    for _ in range(iterations):
        e_anom = m + eph.eccentricity * np.sin(e_anom)
    return e_anom


def satellite_position(eph: Ephemeris, t_sow, kepler_iterations: int = 10) -> np.ndarray:
    """ECEF position (meters) of the SV at GPS time-of-week ``t_sow``.

    Vectorized: ``t_sow`` may be scalar or any-shape array; returns [..., 3].
    Full ICD algorithm: harmonic corrections to argument of latitude, radius,
    inclination; ascending node rotated by the earth rotation rate
    (reference: gypsum/world_model.py:410-487).
    """
    tk = time_from_epoch(t_sow, eph.t_oe)
    ek = eccentric_anomaly(eph, tk, kepler_iterations)
    e = eph.eccentricity

    # True anomaly from eccentric anomaly.
    vk = np.arctan2(np.sqrt(1.0 - e * e) * np.sin(ek), np.cos(ek) - e)
    phi = vk + eph.omega  # argument of latitude

    sin2phi, cos2phi = np.sin(2.0 * phi), np.cos(2.0 * phi)
    du = eph.cus * sin2phi + eph.cuc * cos2phi
    dr = eph.crs * sin2phi + eph.crc * cos2phi
    di = eph.cis * sin2phi + eph.cic * cos2phi

    u = phi + du
    r = eph.semi_major_axis * (1.0 - e * np.cos(ek)) + dr
    i = eph.i0 + eph.idot * tk + di

    x_orb = r * np.cos(u)
    y_orb = r * np.sin(u)

    omega_k = (
        eph.omega0
        + (eph.omega_dot - EARTH_ROTATION_RATE_RAD_PER_S) * tk
        - EARTH_ROTATION_RATE_RAD_PER_S * eph.t_oe
    )

    cos_om, sin_om = np.cos(omega_k), np.sin(omega_k)
    cos_i, sin_i = np.cos(i), np.sin(i)
    x = x_orb * cos_om - y_orb * cos_i * sin_om
    y = x_orb * sin_om + y_orb * cos_i * cos_om
    z = y_orb * sin_i
    return np.stack([x, y, z], axis=-1)


def clock_correction(eph: Ephemeris, t_sow, iterations: int = 10):
    """Total SV clock offset delta_t_sv (s) at time-of-week ``t_sow``:
    polynomial + relativistic term - group delay (IS-GPS-200 §20.3.3.3.3.1;
    reference: gypsum/world_model.py:679-703). Ek and delta_t_sv are mutually
    dependent, so iterate.
    """
    t = np.asarray(t_sow, dtype=np.float64)
    delta = np.zeros_like(t)
    for _ in range(iterations):
        tk = time_from_epoch(t - delta, eph.t_oe)
        ek = eccentric_anomaly(eph, tk)
        delta_rel = (
            RELATIVISTIC_CLOCK_CORRECTION_F * eph.eccentricity * eph.sqrt_a * np.sin(ek)
        )
        dt = time_from_epoch(t, eph.t_oc)
        delta = eph.a_f0 + eph.a_f1 * dt + eph.a_f2 * dt * dt + delta_rel - eph.t_gd
    return delta
