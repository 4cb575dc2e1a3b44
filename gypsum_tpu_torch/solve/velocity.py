"""Doppler-based velocity + receiver clock-drift solve.

A capability the reference receiver lacks entirely (its world model solves
position and clock bias only, gypsum/world_model.py:489-633): the tracking
loops already measure each satellite's carrier Doppler to sub-Hz accuracy,
and those measurements determine the receiver's ECEF velocity and clock
drift by linear least squares — no iteration needed, unlike the position
solve, because the equations are exactly linear in the unknowns.

Model: the measured Doppler of satellite i is

    f_i = -(rho_dot_i + c * b_dot) / lambda,
    rho_dot_i = e_i . (v_sv_i - v_rx),

with e_i the unit line-of-sight vector, v_sv from differentiating the
ephemeris propagation, v_rx the receiver velocity and b_dot the receiver
clock drift (s/s). Rearranged per satellite:

    e_i . v_rx - c * b_dot = e_i . v_sv_i + lambda * f_i

which stacks into one [N, 4] linear system for (v_rx, c*b_dot).

For a static receiver this must recover ~0 m/s despite each satellite's
~700 m/s orbital line-of-sight rate — a strong end-to-end consistency check
of the Doppler measurements, ephemeris propagation, and sign conventions.
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ, SPEED_OF_LIGHT_M_PER_S
from gypsum_tpu_torch.solve.ephemeris import Ephemeris, satellite_position

WAVELENGTH_M = SPEED_OF_LIGHT_M_PER_S / GPS_L1_FREQUENCY_HZ  # ~0.1903 m


def satellite_velocity(
    eph: Ephemeris, t_sow: float, dt: float = 0.25, kepler_iterations: int = 10
) -> np.ndarray:
    """ECEF velocity (m/s) by central difference of the ICD propagation.

    dt = 0.25 s keeps the truncation error of the ~4 km/s, slowly-curving
    orbit far below the Doppler measurement noise (the third derivative of
    GPS orbital position is ~1e-6 m/s^3).
    """
    p_plus = satellite_position(eph, t_sow + dt / 2, kepler_iterations=kepler_iterations)
    p_minus = satellite_position(eph, t_sow - dt / 2, kepler_iterations=kepler_iterations)
    return (p_plus - p_minus) / dt


def solve_velocity(
    sat_positions: np.ndarray,  # [N, 3] ECEF m
    sat_velocities: np.ndarray,  # [N, 3] ECEF m/s
    receiver_ecef: np.ndarray,  # [3] m (from the position fix)
    dopplers_hz: np.ndarray,  # [N] measured carrier Doppler
    wavelengths_m: np.ndarray | None = None,  # [N]; None = GPS L1 everywhere
) -> tuple[np.ndarray, float]:
    """Least-squares (v_rx [3] m/s, clock_drift s/s) from >= 4 Dopplers.

    ``wavelengths_m`` supports mixed constellations (a GLONASS channel's
    Doppler is measured at its own FDMA carrier, ~1602 MHz)."""
    sat_positions = np.asarray(sat_positions, dtype=np.float64)
    sat_velocities = np.asarray(sat_velocities, dtype=np.float64)
    dopplers_hz = np.asarray(dopplers_hz, dtype=np.float64)
    n = len(dopplers_hz)
    if n < 4:
        raise ValueError(f"velocity solve needs >= 4 satellites, got {n}")

    los = sat_positions - receiver_ecef[None, :]
    e = los / np.linalg.norm(los, axis=1, keepdims=True)  # [N, 3]

    a = np.concatenate([e, -np.ones((n, 1))], axis=1)  # [N, 4]
    lam = (
        np.full(n, WAVELENGTH_M)
        if wavelengths_m is None
        else np.asarray(wavelengths_m, dtype=np.float64)
    )
    y = np.einsum("ij,ij->i", e, sat_velocities) + lam * dopplers_hz
    x, *_ = np.linalg.lstsq(a, y, rcond=None)
    v_rx = x[:3]
    clock_drift = x[3] / SPEED_OF_LIGHT_M_PER_S
    return v_rx, float(clock_drift)

def solve_tdcp(
    sat_pos_t0: np.ndarray,  # [N, 3] ECEF m at the interval start emissions
    sat_pos_t1: np.ndarray,  # [N, 3] at the interval end emissions
    sv_clock_delta_s: np.ndarray,  # [N] sv clock corr(t1) - corr(t0)
    receiver_ecef: np.ndarray,  # [3] position at the fix (end of interval)
    delta_phase_cycles: np.ndarray,  # [N] NCO phase advance over the interval
    dt_s: float,
    wavelengths_m: np.ndarray | None = None,  # [N]; None = GPS L1 everywhere
) -> tuple[np.ndarray, float]:
    """Time-differenced carrier phase (TDCP): receiver displacement over one
    tracking block from the carrier's own cycle count — one to two orders of
    magnitude tighter than the Doppler solve, because the NCO phase advance
    integrates the Doppler with millicycle noise instead of sampling it.

    Model (the NCO accumulates cycles = -f_L1 * tau_phase, the synthesizer's
    and tracker's shared convention — solve/rtk.py docstring):

        -lambda * dphi_i + c * dδsv_i
            = |sv_i(t1) - x1| - |sv_i(t0) - x0| + c * db
            ≈ [|sv_i(t1) - x0| - |sv_i(t0) - x0|] - e_i . dx + c * db

    Linear least squares for (dx [3], c*db); returns (velocity = dx/dt,
    clock drift db/dt). Needs >= 4 satellites with continuous (lock-chained)
    phase over the interval.
    """
    sat_pos_t0 = np.asarray(sat_pos_t0, dtype=np.float64)
    sat_pos_t1 = np.asarray(sat_pos_t1, dtype=np.float64)
    x0 = np.asarray(receiver_ecef, dtype=np.float64)
    n = len(delta_phase_cycles)
    if n < 4:
        raise ValueError(f"TDCP solve needs >= 4 satellites, got {n}")

    r0 = np.linalg.norm(sat_pos_t0 - x0[None, :], axis=1)
    r1 = np.linalg.norm(sat_pos_t1 - x0[None, :], axis=1)
    e = (sat_pos_t1 - x0[None, :]) / r1[:, None]

    lam = (
        np.full(n, WAVELENGTH_M)
        if wavelengths_m is None
        else np.asarray(wavelengths_m, dtype=np.float64)
    )
    y = (
        -lam * np.asarray(delta_phase_cycles, dtype=np.float64)
        + SPEED_OF_LIGHT_M_PER_S * np.asarray(sv_clock_delta_s, dtype=np.float64)
        - (r1 - r0)
    )
    a = np.concatenate([-e, np.ones((n, 1))], axis=1)  # [N, 4] for (dx, c db)
    sol, *_ = np.linalg.lstsq(a, y, rcond=None)
    dx = sol[:3]
    db = sol[3] / SPEED_OF_LIGHT_M_PER_S
    return dx / dt_s, float(db / dt_s)
