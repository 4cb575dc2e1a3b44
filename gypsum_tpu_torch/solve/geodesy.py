"""WGS84 geodesy: ECEF <-> latitude/longitude/altitude.

The reference converts only for display, with a one-shot approximation in
kilometers (gypsum/world_model.py:47-68). Here both directions are provided
in meters — the forward direction builds test fixtures, the inverse uses the
standard iterative method to sub-millimeter convergence.
"""

from __future__ import annotations

import numpy as np

WGS84_A = 6378137.0  # semi-major axis, m
WGS84_F = 1.0 / 298.257223563
WGS84_B = WGS84_A * (1.0 - WGS84_F)
WGS84_E_SQ = WGS84_F * (2.0 - WGS84_F)


def lla_to_ecef(lat_deg: float, lon_deg: float, alt_m: float) -> np.ndarray:
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    n = WGS84_A / np.sqrt(1.0 - WGS84_E_SQ * np.sin(lat) ** 2)
    x = (n + alt_m) * np.cos(lat) * np.cos(lon)
    y = (n + alt_m) * np.cos(lat) * np.sin(lon)
    z = (n * (1.0 - WGS84_E_SQ) + alt_m) * np.sin(lat)
    return np.array([x, y, z])


def enu_basis(receiver_ecef: np.ndarray) -> np.ndarray:
    """Rows = geodetic east/north/up unit vectors at the receiver (WGS-84
    geodetic latitude — shared by look-angle and integrity computations so
    both use the same local frame)."""
    lat_deg, lon_deg, _ = ecef_to_lla(np.asarray(receiver_ecef, dtype=np.float64))
    lat, lon = np.radians(lat_deg), np.radians(lon_deg)
    east = np.array([-np.sin(lon), np.cos(lon), 0.0])
    north = np.array(
        [-np.sin(lat) * np.cos(lon), -np.sin(lat) * np.sin(lon), np.cos(lat)]
    )
    up = np.array(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)]
    )
    return np.stack([east, north, up])


def elevation_azimuth(
    receiver_ecef: np.ndarray, sat_ecef: np.ndarray
) -> tuple[float, float]:
    """Satellite look angles from the receiver: (elevation_deg, azimuth_deg),
    azimuth clockwise from true north. Absent from the reference (it never
    computes geometry relative to the receiver); used here for almanac-aided
    visibility prediction and DOP diagnostics."""
    east, north, up = enu_basis(receiver_ecef)
    los = np.asarray(sat_ecef, dtype=np.float64) - np.asarray(
        receiver_ecef, dtype=np.float64
    )
    los = los / np.linalg.norm(los)
    el = np.degrees(np.arcsin(np.clip(los @ up, -1.0, 1.0)))
    az = np.degrees(np.arctan2(los @ east, los @ north)) % 360.0
    return float(el), float(az)


def ecef_to_lla(ecef: np.ndarray) -> tuple[float, float, float]:
    """Returns (lat_deg, lon_deg, alt_m), iterating latitude to convergence."""
    x, y, z = float(ecef[0]), float(ecef[1]), float(ecef[2])
    lon = np.arctan2(y, x)
    p = np.hypot(x, y)
    lat = np.arctan2(z, p * (1.0 - WGS84_E_SQ))
    for _ in range(10):
        n = WGS84_A / np.sqrt(1.0 - WGS84_E_SQ * np.sin(lat) ** 2)
        alt = p / np.cos(lat) - n
        lat = np.arctan2(z, p * (1.0 - WGS84_E_SQ * n / (n + alt)))
    n = WGS84_A / np.sqrt(1.0 - WGS84_E_SQ * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return float(np.degrees(lat)), float(np.degrees(lon)), float(alt)
