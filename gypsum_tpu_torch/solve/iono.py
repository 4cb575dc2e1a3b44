"""Klobuchar ionospheric delay + GPS->UTC conversion from subframe 4 page 18.

The reference parses no subframe-4 payload at all
(gypsum/navigation_message_parser.py:599-618), so every reference fix eats
the full ionospheric group delay (meters to tens of meters). This module
implements the single-frequency correction the broadcast message exists to
enable: the 8-coefficient Klobuchar model (IS-GPS-200 §20.3.3.5.2.5) and
the UTC polynomial (§20.3.3.5.2.4).

All angles in the model are in SEMICIRCLES (the ICD's units); inputs here
are degrees/radians as documented per function and converted internally.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.nav.subframes import Subframe4Page18


@dataclass(frozen=True)
class IonoUtcParams:
    """Decoded page-18 parameters in ICD units."""

    alpha: tuple[float, float, float, float]  # s, s/sc, s/sc^2, s/sc^3
    beta: tuple[float, float, float, float]  # s, s/sc, ...
    a0_utc: float
    a1_utc: float
    t_ot: float
    wn_t: int
    delta_t_ls: int

    @classmethod
    def from_page(cls, page: Subframe4Page18) -> "IonoUtcParams":
        return cls(
            alpha=(page.alpha0, page.alpha1, page.alpha2, page.alpha3),
            beta=(page.beta0, page.beta1, page.beta2, page.beta3),
            a0_utc=page.a0_utc,
            a1_utc=page.a1_utc,
            t_ot=page.t_ot,
            wn_t=page.wn_t,
            delta_t_ls=page.delta_t_ls,
        )


def klobuchar_delay_s(
    params: IonoUtcParams,
    user_lat_deg: float,
    user_lon_deg: float,
    elevation_deg: float,
    azimuth_deg: float,
    gps_tow_s: float,
) -> float:
    """L1 ionospheric group delay (seconds) per IS-GPS-200 §20.3.3.5.2.5.

    The algorithm maps the receiver->SV line of sight to an ionospheric
    pierce point, evaluates the model's diurnal cosine there, and scales by
    the slant obliquity. Semicircle units throughout (1 sc = 180 deg)."""
    e = max(elevation_deg, 0.0) / 180.0  # semicircles
    a = np.deg2rad(azimuth_deg)
    phi_u = user_lat_deg / 180.0
    lam_u = user_lon_deg / 180.0

    # Earth-centered angle to the pierce point (semicircles).
    psi = 0.0137 / (e + 0.11) - 0.022
    phi_i = phi_u + psi * np.cos(a)
    phi_i = float(np.clip(phi_i, -0.416, 0.416))
    lam_i = lam_u + psi * np.sin(a) / np.cos(phi_i * np.pi)
    # Geomagnetic latitude of the pierce point.
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * np.pi)
    # Local time at the pierce point.
    t = 4.32e4 * lam_i + gps_tow_s
    t = t % 86400.0

    f = klobuchar_obliquity(elevation_deg)  # slant obliquity
    per = sum(b * phi_m**n for n, b in enumerate(params.beta))
    per = max(per, 72_000.0)
    amp = sum(al * phi_m**n for n, al in enumerate(params.alpha))
    amp = max(amp, 0.0)
    x = 2.0 * np.pi * (t - 50_400.0) / per
    if abs(x) < 1.57:
        night_day = 5e-9 + amp * (1.0 - x * x / 2.0 + x**4 / 24.0)
    else:
        night_day = 5e-9
    return float(f * night_day)


def klobuchar_obliquity(elevation_deg: float) -> float:
    """Slant obliquity factor F of IS-GPS-200 §20.3.3.5.2.5 — the ratio of
    slant to vertical ionospheric delay for a thin-shell ionosphere. Shared
    by the model above and the cross-constellation measured-iono mapping
    (solve/world_multiconstellation.py:iono_vertical_gps_l1_m), so the two
    paths are obliquity-consistent."""
    e = max(elevation_deg, 0.0) / 180.0  # semicircles
    return float(1.0 + 16.0 * (0.53 - e) ** 3)


def gps_to_utc_offset_s(params: IonoUtcParams, gps_tow_s: float) -> float:
    """Seconds to SUBTRACT from GPS time to get UTC:
    delta_t_UTC = delta_t_LS + A0 + A1 (t - t_ot) (IS-GPS-200
    §20.3.3.5.2.4, ignoring the week-number term for same-week use)."""
    return params.delta_t_ls + params.a0_utc + params.a1_utc * (gps_tow_s - params.t_ot)
