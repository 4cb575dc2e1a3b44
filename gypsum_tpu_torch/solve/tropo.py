"""Tropospheric delay model (Saastamoinen, standard atmosphere).

The troposphere delays code AND carrier equally (non-dispersive) by
~2.4 m at zenith, growing to ~10+ m at low elevation — after the
ionosphere, the next systematic error a single-frequency receiver can
remove with a model. The reference applies no atmospheric corrections at
all; this framework injects the same model in the synthesizer
(signal/constellation.py) so the correction is validated end-to-end.

Model: Saastamoinen zenith delay from a standard-atmosphere
pressure/temperature/humidity profile at the receiver altitude, mapped to
the slant by 1/sin(el) (adequate above ~10 deg; clamped below).
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.core.constants import SPEED_OF_LIGHT_M_PER_S as C


def saastamoinen_delay_m(
    elevation_deg: float,
    altitude_m: float = 0.0,
    relative_humidity: float = 0.5,
) -> float:
    """Slant tropospheric delay in meters."""
    h = float(np.clip(altitude_m, -500.0, 10_000.0))
    # ICAO standard atmosphere.
    p_hpa = 1013.25 * (1.0 - 2.2557e-5 * h) ** 5.2568
    t_k = 288.15 - 0.0065 * h
    # Saturation vapor pressure (hPa) x relative humidity.
    e_hpa = relative_humidity * 6.108 * np.exp(
        (17.15 * t_k - 4684.0) / (t_k - 38.45)
    )
    zenith = 0.002277 * (p_hpa + (1255.0 / t_k + 0.05) * e_hpa)
    sin_el = max(np.sin(np.deg2rad(max(elevation_deg, 5.0))), 0.05)
    return float(zenith / sin_el)


def tropo_delay_s(elevation_deg: float, altitude_m: float = 0.0) -> float:
    """Slant delay in seconds (what pseudorange corrections consume)."""
    return saastamoinen_delay_m(elevation_deg, altitude_m) / C
