"""Ready-made constellation scenarios for demos, benches, and fixtures.

GPS-like broadcast ephemerides (a ~ 26,560 km, e ~ 0.012, i ~ 55 deg) with
node/anomaly spreads chosen so the first several satellites are well-placed
for a mid-latitude receiver around t = 21600 s of week. The synthetic capture
produced from these is the framework's stand-in for the reference's vendored
nov_3 recording (reference: gypsum/radio_input.py:101-105).
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.core.constants import GPS_PI
from gypsum_tpu_torch.solve.ephemeris import Ephemeris


def make_ephemeris(
    omega0: float,
    m0: float,
    omega: float = 0.6,
    eccentricity: float = 0.012,
    a_f0: float = 1.2e-4,
    t_oe: float = 21600.0,
) -> Ephemeris:
    return Ephemeris(
        sqrt_a=5153.65,
        eccentricity=eccentricity,
        i0=0.9617,  # ~55.1 deg
        omega0=omega0,
        omega=omega,
        m0=m0,
        delta_n=1.42e-09 * GPS_PI,
        idot=2.8e-10 * GPS_PI,
        omega_dot=-2.51e-09 * GPS_PI,
        cuc=-6.03e-06, cus=7.22e-06,
        crc=221.6875, crs=-115.15625,
        cic=-1.11e-08, cis=2.04e-08,
        t_oe=t_oe,
        a_f0=a_f0, a_f1=-3.6e-12, a_f2=0.0,
        t_oc=t_oe, t_gd=4.65e-09,
        week_number=250,
    )


# Visible from ~(51.5N, 0.1W) at t ~ 21600 s: the first EIGHT slots are
# above 15 deg elevation with azimuths spread around the full sky (4/56/82/
# 146/150/176/189/212/287 deg), so scenes of 4-8 satellites have good
# geometry; the last two sit below -25 deg elevation throughout the first
# minute (verified by solve/geodesy.py:elevation_azimuth — tests/
# test_almanac.py pins both claims), useful as absent-satellite controls and
# for the almanac horizon-mask tests.
DEMO_EPHEMERIDES: list[Ephemeris] = [
    make_ephemeris(omega0=-0.30, m0=0.40, a_f0=1.2e-4),
    make_ephemeris(omega0=-0.90, m0=1.90, a_f0=-0.8e-4),
    make_ephemeris(omega0=0.60, m0=0.60, a_f0=0.5e-4),
    make_ephemeris(omega0=0.10, m0=1.10, omega=1.2, a_f0=2.0e-4),
    make_ephemeris(omega0=0.10, m0=0.90, a_f0=-0.4e-4),  # az ~4, el ~85
    make_ephemeris(omega0=1.35, m0=0.90, a_f0=1.6e-4),  # az ~56, el ~38
    make_ephemeris(omega0=-1.40, m0=2.40, omega=0.3, a_f0=-1.1e-4),  # az ~189, el ~49
    make_ephemeris(omega0=-1.65, m0=2.10, a_f0=0.7e-4),  # az ~212, el ~45
    make_ephemeris(omega0=-2.75, m0=4.50, a_f0=-1.5e-4),  # el ~ -34: below horizon
    make_ephemeris(omega0=-3.00, m0=4.20, omega=0.2, a_f0=0.9e-4),  # el ~ -29: below horizon
]

DEMO_PRNS = [25, 28, 31, 32]
DEMO_PRNS_8 = [25, 28, 31, 32, 3, 7, 14, 19]
DEMO_RECEIVER_LLA = (51.5, -0.1, 80.0)
DEMO_GPS_START_SOW = 21600.0


def demo_constellation(prns: list[int] | None = None, amplitude: float = 0.22):
    """[(ConstellationSatellite, ...)] for the demo scene."""
    from gypsum_tpu_torch.signal.constellation import ConstellationSatellite

    prns = prns or DEMO_PRNS
    return [
        ConstellationSatellite(prn=p, ephemeris=DEMO_EPHEMERIDES[i % len(DEMO_EPHEMERIDES)], amplitude=amplitude)
        for i, p in enumerate(prns)
    ]


def demo_receiver_ecef() -> np.ndarray:
    from gypsum_tpu_torch.solve.geodesy import lla_to_ecef

    return lla_to_ecef(*DEMO_RECEIVER_LLA)


def demo_sbas_geo(prn: int = 120, amplitude: float = 0.22):
    """An EGNOS-like GEO at 15.5 W (~31 deg elevation from the demo receiver
    at 51.5 N) broadcasting MT9 every 4 s — the SBAS counterpart of
    demo_constellation for mixed-family scenes."""
    from gypsum_tpu_torch.nav.sbas import GeoNavigationMessage
    from gypsum_tpu_torch.signal.constellation import SbasGeoSatellite

    r_geo = 42164e3
    lon = np.deg2rad(-15.5)
    geo = GeoNavigationMessage(
        prn=prn,
        t0_sec_of_day=DEMO_GPS_START_SOW % 86400.0,
        ura=2,
        xyz_m=(r_geo * np.cos(lon), r_geo * np.sin(lon), 11000.0),
        vel_mps=(0.8, -1.6, 2.4),
        acc_mps2=(-1.25e-4, 5.0e-5, 1.25e-4),
        a_gf0_s=3.1e-8,
        a_gf1_ss=0.0,
    )
    return SbasGeoSatellite(prn=prn, geo=geo, amplitude=amplitude, mt9_every=4)


def demo_iono_page18():
    """A representative daytime Klobuchar broadcast (subframe 4 page 18),
    quantized to transmitted precision so the synthesizer's injected delay
    and a receiver's decoded correction agree exactly. Zenith delay at the
    demo location/epoch is ~25 ns (~7.5 m of L1 pseudorange)."""
    from gypsum_tpu_torch.nav.subframes import (
        PAGE18_SV_ID,
        Subframe4Page18,
        roundtrip_fields,
    )

    return roundtrip_fields(Subframe4Page18(
        data_id=1,
        page_id=PAGE18_SV_ID,
        alpha0=8.0e-8, alpha1=3.0e-8, alpha2=-6.0e-8, alpha3=0.0,
        beta0=131072.0, beta1=98304.0, beta2=-65536.0, beta3=0.0,
        a1_utc=2.0e-15, a0_utc=3.0e-9, t_ot=147456.0, wn_t=250 % 256,
        delta_t_ls=18, wn_lsf=250 % 256, dn=7, delta_t_lsf=18,
    ))


# ------------------------------------------------------------------ GLONASS

# Demo GLONASS band: front end centered at 1602 MHz, sampled at 4.092 Msps
# (one 511-chip / 1 ms code period = 4092 samples; FDMA channels out to
# k = +/-2 fit inside Nyquist with their full +/-511 kHz main lobes).
DEMO_GLONASS_SAMPLE_RATE = 4.092e6
# GLONASS-day time of the scene origin (DEMO_GPS_START_SOW = 21600 ->
# UTC 05:59:42 -> Moscow 08:59:42 = 32382 s); tb at the next 15-min grid.
DEMO_GLONASS_TB_DAY_S = 36 * 900.0  # 32400 s, 18 s after scene start


def demo_glonass_constellation(
    frequency_numbers: list[int] | None = None, amplitude: float = 0.22
):
    """[GlonassSatellite, ...]: well-spread look geometries from the demo
    receiver, one FDMA channel each (defaults k = -2..+2)."""
    from gypsum_tpu_torch.signal.constellation import GlonassSatellite
    from gypsum_tpu_torch.solve.glonass import glonass_ephemeris_from_look

    ks = frequency_numbers if frequency_numbers is not None else [-2, -1, 0, 1, 2]
    looks = [  # (elevation, azimuth, heading) spread around the sky
        (62.0, 35.0, 25.0),
        (48.0, 140.0, 160.0),
        (35.0, 215.0, 75.0),
        (55.0, 305.0, -40.0),
        (28.0, 85.0, 120.0),
        (41.0, 255.0, -130.0),
    ]
    rx = demo_receiver_ecef()
    out = []
    for i, k in enumerate(ks):
        el, az, heading = looks[i % len(looks)]
        out.append(GlonassSatellite(
            ephemeris=glonass_ephemeris_from_look(
                rx, el, az, frequency_number=k,
                tb_day_s=DEMO_GLONASS_TB_DAY_S, heading_deg=heading,
                tau_n_s=(2.0 * i - 4.0) * 1e-5, gamma_n=(i - 2) * 4e-12,
                slot=i + 1,
            ),
            amplitude=amplitude,
        ))
    return out
