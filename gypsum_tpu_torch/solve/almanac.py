"""Almanac accumulation and sky prediction (warm-start aid).

The reference parses subframe-5 almanac pages in full
(gypsum/navigation_message_parser.py:620-673) but never *uses* them — pages
are decoded and dropped. Here the almanac earns its keep: once any satellite
has relayed the constellation almanac and a first fix exists, the receiver
can predict every SV's elevation, azimuth, and Doppler, and skip acquisition
scans for satellites that are below the horizon (a real receiver's
warm-start behavior, IS-GPS-200 §20.3.3.5.1.2: almanac is "a reduced-
precision subset of the ... ephemeris" intended exactly for acquisition
aiding).

The almanac orbit model is the ephemeris model with the precision terms
zeroed (no delta_n, no idot, no harmonic corrections) and the inclination
expressed as an offset from the 0.30-semicircle reference, so the existing
``satellite_position`` Kepler/ECEF propagation applies unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GPS_L1_FREQUENCY_HZ,
    GPS_PI,
    SPEED_OF_LIGHT_M_PER_S,
)
from gypsum_tpu_torch.nav.subframes import Subframe5
from gypsum_tpu_torch.solve.ephemeris import Ephemeris, satellite_position
from gypsum_tpu_torch.solve.geodesy import elevation_azimuth

# IS-GPS-200 §20.3.3.5.2.2: delta_i is relative to i = 0.30 semicircles.
ALMANAC_REFERENCE_INCLINATION_SEMICIRCLES = 0.30


def ephemeris_from_almanac(page: Subframe5, week_number: int | None = None) -> Ephemeris:
    """Reduced-precision Ephemeris from one almanac page (semicircle fields
    converted to radians, precision terms zeroed)."""
    return Ephemeris(
        sqrt_a=page.sqrt_a,
        eccentricity=page.eccentricity,
        i0=(ALMANAC_REFERENCE_INCLINATION_SEMICIRCLES + page.delta_i) * GPS_PI,
        omega0=page.omega0 * GPS_PI,
        omega=page.omega * GPS_PI,
        m0=page.m0 * GPS_PI,
        delta_n=0.0,
        idot=0.0,
        omega_dot=page.omega_dot * GPS_PI,
        cuc=0.0, cus=0.0, crc=0.0, crs=0.0, cic=0.0, cis=0.0,
        t_oe=page.t_oa,
        a_f0=page.a_f0,
        a_f1=page.a_f1,
        a_f2=0.0,
        t_oc=page.t_oa,
        t_gd=0.0,
        week_number=week_number,
    )


def almanac_page_from_ephemeris(prn: int, eph: Ephemeris) -> Subframe5:
    """Inverse of ``ephemeris_from_almanac`` for fixtures and the scene
    synthesizer: degrade a precise ephemeris to one transmitted-precision
    almanac page describing SV ``prn``.

    t_oa lives on a 4096 s grid (8 bits x 2^12), so the orbit is re-epoched:
    the angular elements are propagated from t_oe to the quantized t_oa
    (mean motion, node rate, inclination rate) exactly as an operational
    almanac fit would, keeping the predicted positions aligned despite the
    coarse epoch."""
    from gypsum_tpu_torch.core.constants import EARTH_GRAVITATIONAL_PARAM
    from gypsum_tpu_torch.nav.subframes import roundtrip_fields

    t_oa = float(np.round(eph.t_oe / 4096.0) * 4096.0)
    dt = t_oa - eph.t_oe
    n = np.sqrt(EARTH_GRAVITATIONAL_PARAM) / eph.semi_major_axis**1.5 + eph.delta_n

    def wrap_semicircles(rad: float) -> float:
        return ((rad / GPS_PI + 1.0) % 2.0) - 1.0

    return roundtrip_fields(
        Subframe5(
            data_id=1,
            almanac_sv_id=prn,
            eccentricity=eph.eccentricity,
            t_oa=t_oa,
            delta_i=(eph.i0 + eph.idot * dt) / GPS_PI
            - ALMANAC_REFERENCE_INCLINATION_SEMICIRCLES,
            omega_dot=eph.omega_dot / GPS_PI,
            sv_health=0,
            sqrt_a=eph.sqrt_a,
            # Omega_k depends on -EARTH_ROTATION * t_oe through the epoch
            # term, and on (omega_dot - EARTH_ROTATION) * tk; both epoch
            # shifts combine to a net + omega_dot * dt (the earth-rate parts
            # cancel).
            omega0=wrap_semicircles(eph.omega0 + eph.omega_dot * dt),
            omega=eph.omega / GPS_PI,
            m0=wrap_semicircles(eph.m0 + n * dt),
            a_f0=eph.a_f0 + eph.a_f1 * dt,
            a_f1=eph.a_f1,
        )
    )


def almanac_pages_for_scene(orbits: dict[int, Ephemeris]) -> list[Subframe5]:
    """The page set every SV in a synthesized scene relays (PRN order)."""
    return [
        almanac_page_from_ephemeris(prn, eph) for prn, eph in sorted(orbits.items())
    ]


@dataclass(frozen=True)
class SkyPrediction:
    """Predicted look geometry for one SV at one instant."""

    prn: int
    elevation_deg: float
    azimuth_deg: float
    doppler_hz: float  # carrier Doppler seen by a static receiver
    from_almanac: bool  # True = reduced-precision orbit (no ephemeris yet)

    @property
    def visible(self) -> bool:
        return self.elevation_deg > 0.0


def predict_sky(
    orbits: dict[int, Ephemeris],
    receiver_ecef: np.ndarray,
    tow_s: float,
    from_almanac: bool = False,
) -> dict[int, SkyPrediction]:
    """Elevation/azimuth/Doppler for each orbit at GPS time ``tow_s``.

    Doppler is the ECEF range-rate (central difference over 1 s — the
    standard user algorithm already bakes Earth rotation into the ECEF
    trajectory) scaled to L1. Almanac-grade orbits predict Doppler to a few
    hundred Hz, well inside one coarse acquisition bin."""
    rx = np.asarray(receiver_ecef, dtype=np.float64)
    out: dict[int, SkyPrediction] = {}
    for prn, eph in orbits.items():
        pos = satellite_position(eph, tow_s)
        el, az = elevation_azimuth(rx, pos)
        r_minus = np.linalg.norm(satellite_position(eph, tow_s - 0.5) - rx)
        r_plus = np.linalg.norm(satellite_position(eph, tow_s + 0.5) - rx)
        range_rate = float(r_plus - r_minus)  # m/s over the 1 s window
        doppler = -range_rate / SPEED_OF_LIGHT_M_PER_S * GPS_L1_FREQUENCY_HZ
        out[prn] = SkyPrediction(
            prn=prn, elevation_deg=el, azimuth_deg=az,
            doppler_hz=doppler, from_almanac=from_almanac,
        )
    return out


class AlmanacStore:
    """Latest almanac page per described SV, merged across transmitters.

    Every satellite broadcasts the whole constellation's almanac, so pages
    arriving on any tracked channel fill one shared store (keyed by the
    page's ``almanac_sv_id``, NOT the transmitting PRN)."""

    def __init__(self) -> None:
        self._pages: dict[int, Subframe5] = {}

    def ingest(self, page: Subframe5) -> bool:
        """Store a page; returns True if it described a valid SV (1-32).
        Dummy/reserved pages (sv_id 0 or > 32) are ignored, as are pages for
        unhealthy SVs marked all-ones (IS-GPS-200 §20.3.3.5.1.3)."""
        sv = page.almanac_sv_id
        if not (1 <= sv <= 32):
            return False
        # An all-ones 8-bit health word marks the SV unusable
        # (IS-GPS-200 §20.3.3.5.1.3): keep it out of sky prediction and the
        # warm-start scan mask.
        if page.sv_health == 0xFF:
            return False
        self._pages[sv] = page
        return True

    def __len__(self) -> int:
        return len(self._pages)

    def __contains__(self, prn: int) -> bool:
        return prn in self._pages

    def page(self, prn: int) -> Subframe5 | None:
        return self._pages.get(prn)

    def orbits(self, week_number: int | None = None) -> dict[int, Ephemeris]:
        return {
            prn: ephemeris_from_almanac(p, week_number)
            for prn, p in self._pages.items()
        }
