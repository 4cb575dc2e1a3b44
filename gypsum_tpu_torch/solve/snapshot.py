"""Snapshot (coarse-time) positioning: a fix from one acquisition, no decode.

Beyond the reference (which must track for ~18-30 s to decode TOW + ephemeris
before it can attempt a fix, reference: gypsum/world_model.py:567-589): given
satellite orbits from a previous session (decoded ephemerides via
checkpoint/almanac) plus coarse priors — position to ~100 km, time to ~10 s —
a single ~10-100 ms acquisition snapshot already fixes the receiver. This is
the classic assisted-GNSS "coarse-time navigation" problem (F. van Diggelen,
A-GPS, ch. 4): the acquisition engine measures each satellite's code phase,
i.e. its pseudorange modulo the 1 ms code period; the integer milliseconds
and the true observation time are reconstructed by iterating

  1. predict pseudo-transit from the assumed position/time,
  2. fix each integer N_i = round(predicted - fraction),
  3. solve the 5-unknown least squares (position, common clock bias, and a
     coarse-time correction whose observability comes from satellite range
     rates, +/-800 m/s per satellite),

re-fixing integers as the estimate improves. Needs >= 5 satellites for the
time state (>= 4 with ``solve_time=False``). Convergence basin: position
error < ~150 km (half a code-period of range), time error < ~1 min (range
prediction error from satellite motion must stay < 0.5 ms of range).

The range convention matches the rest of the solver (solve/world.py):
straight ECEF distance to the satellite position at emission time — the same
convention the synthesizer's light-time iteration uses.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.constants import SPEED_OF_LIGHT_M_PER_S as C

_MS = 1e-3


@dataclass(frozen=True)
class SnapshotMeasurement:
    """One acquired satellite: the code phase as a sub-millisecond
    pseudorange fraction (code_phase_samples / sample_rate)."""

    prn: int
    code_phase_fraction_s: float  # in [0, 1 ms)
    doppler_hz: float | None = None  # optional, diagnostics only


@dataclass(frozen=True)
class SnapshotSolution:
    ecef: np.ndarray  # [3] m
    clock_bias_s: float  # receiver clock bias (common, sub-ms + integer part)
    time_correction_s: float  # add to the assumed coarse time
    residual_rms_m: float
    iterations: int
    prns: tuple[int, ...]


def snapshot_fix(
    measurements: list[SnapshotMeasurement],
    orbit_fn,
    coarse_time_sow: float,
    coarse_position_ecef: np.ndarray,
    solve_time: bool = True,
    iterations: int = 12,
) -> SnapshotSolution | None:
    """Coarse-time least squares over one snapshot's code phases.

    ``orbit_fn(prn, sv_tow) -> (position[3] m, velocity[3] m/s, clock_corr s)``
    — satellite state at emission time (ephemeris- or almanac-grade; SBAS
    GEOs via their MT9 polynomial work too). Returns None when the system is
    underdetermined or the iteration diverges out of its basin.
    """
    n = len(measurements)
    n_states = 5 if solve_time else 4
    if n < n_states:
        return None

    pos = np.asarray(coarse_position_ecef, dtype=np.float64).copy()
    bias_m = 0.0  # c * receiver clock bias
    dt = 0.0  # coarse-time correction (s)
    frac = np.array([m.code_phase_fraction_s for m in measurements])
    prns = [m.prn for m in measurements]

    for it in range(iterations):
        t_obs = coarse_time_sow + dt
        sat_pos = np.empty((n, 3))
        sat_vel = np.empty((n, 3))
        dtsv = np.empty(n)
        tau = np.full(n, 0.075)
        for _ in range(2):  # light-time iteration
            for i, prn in enumerate(prns):
                p, v, dc = orbit_fn(prn, t_obs - tau[i])
                sat_pos[i], sat_vel[i], dtsv[i] = p, v, dc
            tau = np.linalg.norm(sat_pos - pos[None, :], axis=1) / C

        # Predicted pseudo-transit (s) at the current estimate; fix the
        # integer milliseconds of each measured fraction against it.
        pred_s = tau - dtsv + bias_m / C
        n_ms = np.round((pred_s - frac) / _MS)
        pr_m = (n_ms * _MS + frac) * C  # reconstructed full pseudoranges

        rng = np.linalg.norm(sat_pos - pos[None, :], axis=1)
        e = (sat_pos - pos[None, :]) / rng[:, None]
        pred_m = rng - C * dtsv + bias_m
        res = pr_m - pred_m  # [n] meters

        # Jacobian rows: d pred / d [pos, bias_m, dt].
        cols = [-e, np.ones((n, 1))]
        if solve_time:
            # Range rate: satellite motion only (the receiver is static over
            # the snapshot); this is what makes the time error observable.
            rr = np.sum(e * sat_vel, axis=1)  # m/s
            cols.append(rr[:, None])
        h = np.concatenate(cols, axis=1)  # [n, 4 or 5]
        try:
            delta, *_ = np.linalg.lstsq(h, res, rcond=None)
        except np.linalg.LinAlgError:
            return None
        pos += delta[:3]
        bias_m += delta[3]
        if solve_time:
            dt += delta[4]
        if np.linalg.norm(delta[:3]) < 1e-4:
            break

    if not np.all(np.isfinite(pos)) or np.linalg.norm(pos) > 1e8:
        return None
    final_res = res - h @ delta
    return SnapshotSolution(
        ecef=pos,
        clock_bias_s=bias_m / C,
        time_correction_s=dt,
        residual_rms_m=float(np.sqrt(np.mean(final_res**2))),
        iterations=it + 1,
        prns=tuple(prns),
    )


def orbit_fn_from_records(sats: dict, kepler_iterations: int = 10):
    """Adapt a WorldModel's satellite records (solve/world.py) — or any
    mapping prn -> object with sv_position/sv_velocity/sv_clock_correction —
    into the ``orbit_fn`` callback."""

    def orbit_fn(prn: int, sv_tow: float):
        rec = sats[prn]
        return (
            rec.sv_position(sv_tow, kepler_iterations=kepler_iterations),
            rec.sv_velocity(sv_tow, kepler_iterations=kepler_iterations),
            rec.sv_clock_correction(sv_tow, iterations=4),
        )

    return orbit_fn


def orbit_fn_from_ephemerides(ephemerides: dict, kepler_iterations: int = 10):
    """orbit_fn over plain {prn: Ephemeris} (e.g. test fixtures or an
    almanac's reduced-precision orbits)."""
    from gypsum_tpu_torch.solve.ephemeris import clock_correction, satellite_position
    from gypsum_tpu_torch.solve.velocity import satellite_velocity

    def orbit_fn(prn: int, sv_tow: float):
        eph = ephemerides[prn]
        return (
            satellite_position(eph, sv_tow, kepler_iterations=kepler_iterations),
            satellite_velocity(eph, sv_tow, kepler_iterations=kepler_iterations),
            float(clock_correction(eph, sv_tow)),
        )

    return orbit_fn

def doppler_position_seed(
    measurements: list[tuple[int, float]],
    orbit_fn,
    time_sow: float,
    initial_ecef: np.ndarray | None = None,
    iterations: int = 12,
) -> np.ndarray | None:
    """Coarse receiver position from measured carrier Dopplers alone.

    The classic Doppler-positioning bootstrap (assisted-GNSS cold start with
    NO position prior): each satellite's received Doppler is
    ``-f/c * d|sv - rx|/dt + b`` with ``b`` a common receiver LO offset, so
    >= 4 (prn, doppler_hz) pairs determine [rx (3), b]. Sensitivity is
    ~|v_sv|/range ~ 1.8e-4 Hz per meter: 1 Hz of tracker Doppler noise maps
    to ~1 km of position — far inside ``snapshot_fix``'s ~150 km
    convergence basin, which is exactly the job of this seed.

    Returns ECEF [3] m or None (underdetermined / diverged). ``time_sow``
    must be right to ~seconds (satellite velocity rotates slowly).
    """
    from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
    from gypsum_tpu_torch.core.constants import SPEED_OF_LIGHT_M_PER_S as C_

    n = len(measurements)
    if n < 4:
        return None
    prns = [p for p, _ in measurements]
    fd = np.array([d for _, d in measurements], dtype=np.float64)

    sat_pos = np.empty((n, 3))
    sat_vel = np.empty((n, 3))
    for i, prn in enumerate(prns):
        p, v, _ = orbit_fn(prn, time_sow - 0.075)
        sat_pos[i], sat_vel[i] = p, v

    if initial_ecef is None:
        # Surface point under the constellation centroid: always inside the
        # footprint of the satellites actually being received.
        centroid = sat_pos.mean(axis=0)
        pos = 6371e3 * centroid / np.linalg.norm(centroid)
    else:
        pos = np.asarray(initial_ecef, dtype=np.float64).copy()
    bias_hz = 0.0
    k = GPS_L1_FREQUENCY_HZ / C_

    for _ in range(iterations):
        dx = sat_pos - pos[None, :]
        rng = np.linalg.norm(dx, axis=1)
        e = dx / rng[:, None]
        rdot = np.sum(e * sat_vel, axis=1)  # d|sv-rx|/dt (receiver static)
        pred = -k * rdot + bias_hz
        res = fd - pred
        # d(rdot)/d(rx) = (e (e.v) - v) / range  =>  d(pred)/d(rx) = -k * that.
        d_rdot = (e * rdot[:, None] - sat_vel) / rng[:, None]
        h = np.concatenate([-k * d_rdot, np.ones((n, 1))], axis=1)
        try:
            delta, *_ = np.linalg.lstsq(h, res, rcond=None)
        except np.linalg.LinAlgError:
            return None
        pos += delta[:3]
        bias_hz += delta[3]
        if np.linalg.norm(delta[:3]) < 1.0:
            break
    if not np.all(np.isfinite(pos)) or np.linalg.norm(pos) > 1e8:
        return None
    return pos
