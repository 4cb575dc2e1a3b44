"""Position/time solve: Newton's method on squared-range residuals.

Same mathematical formulation as the reference (squared-distance residuals
with analytic Jacobian over (x, y, z, clock bias),
gypsum/world_model.py:489-551) with one robustness upgrade: the linear step
uses least squares, so any number >= 4 of satellites contributes (the
reference's np.linalg.solve requires exactly four).
"""

from __future__ import annotations

import numpy as np

from gypsum_tpu_torch.core.constants import SPEED_OF_LIGHT_M_PER_S as C


def solve_position(
    sat_positions: np.ndarray,  # [N, 3] ECEF meters
    pseudo_transit_times: np.ndarray,  # [N] seconds (includes receiver bias)
    initial_position: np.ndarray | None = None,
    initial_bias: float = 0.0,
    iterations: int = 20,
) -> tuple[np.ndarray, float]:
    """Returns (receiver_ecef [3], clock_bias_seconds).

    Residual_i = |p - s_i|^2 - (c (t_i - b))^2 — driving all residuals to zero
    places the receiver on every satellite's range sphere simultaneously.
    """
    sats = np.asarray(sat_positions, dtype=np.float64)
    times = np.asarray(pseudo_transit_times, dtype=np.float64)
    if sats.shape[0] < 4:
        raise ValueError(f"need >= 4 satellites, got {sats.shape[0]}")

    pos = np.zeros(3) if initial_position is None else np.asarray(initial_position, dtype=np.float64).copy()
    bias = float(initial_bias)

    for _ in range(iterations):
        diff = pos[None, :] - sats  # [N, 3]
        ranges_sq = np.sum(diff * diff, axis=1)
        light = C * (times - bias)
        residuals = ranges_sq - light * light
        jacobian = np.concatenate(
            [2.0 * diff, (2.0 * C * C * (times - bias))[:, None]], axis=1
        )  # [N, 4]
        step, *_ = np.linalg.lstsq(jacobian, -residuals, rcond=None)
        pos += step[:3]
        bias += step[3]
        # Converged (quadratic convergence makes further iterations exact
        # no-ops at f64): sub-0.1 mm position AND clock step. A warm start
        # from the previous fix lands here in 2-3 iterations instead of
        # riding out all 20 — the fix is attempted every block, so this is
        # real serial host time.
        if np.abs(step[:3]).max() < 1e-4 and abs(step[3]) * C < 1e-4:
            break
    return pos, bias


def solve_position_multi(
    sat_positions: np.ndarray,  # [N, 3] ECEF meters
    pseudo_transit_times: np.ndarray,  # [N] seconds (includes receiver bias)
    system_of: np.ndarray,  # [N] int — constellation index 0..K-1 per row
    initial_position: np.ndarray | None = None,
    initial_biases: np.ndarray | None = None,
    iterations: int = 20,
) -> tuple[np.ndarray, np.ndarray]:
    """Multi-constellation solve: (receiver_ecef [3], clock_biases [K]).

    Each constellation gets its own receiver clock unknown — the standard
    GPS+GLONASS formulation, where the inter-system bias (hardware delays +
    the sub-microsecond GGTO-like time offset) is ESTIMATED, never assumed.
    Needs >= 3 + K measurements with every system represented; K = 1 reduces
    exactly to :func:`solve_position`.
    """
    sats = np.asarray(sat_positions, dtype=np.float64)
    times = np.asarray(pseudo_transit_times, dtype=np.float64)
    sys_idx = np.asarray(system_of, dtype=np.int64)
    k = int(sys_idx.max()) + 1 if len(sys_idx) else 0
    if sats.shape[0] < 3 + k:
        raise ValueError(
            f"need >= {3 + k} satellites for {k} constellations, got {sats.shape[0]}"
        )
    if set(np.unique(sys_idx)) != set(range(k)):
        raise ValueError("every constellation index 0..K-1 must appear")
    onehot = np.eye(k)[sys_idx]  # [N, K]

    pos = (
        np.zeros(3)
        if initial_position is None
        else np.asarray(initial_position, dtype=np.float64).copy()
    )
    biases = (
        np.zeros(k)
        if initial_biases is None
        else np.asarray(initial_biases, dtype=np.float64).copy()
    )
    for _ in range(iterations):
        diff = pos[None, :] - sats  # [N, 3]
        ranges_sq = np.sum(diff * diff, axis=1)
        b_row = onehot @ biases  # [N]
        light = C * (times - b_row)
        residuals = ranges_sq - light * light
        jacobian = np.concatenate(
            [2.0 * diff, (2.0 * C * C * (times - b_row))[:, None] * onehot], axis=1
        )  # [N, 3 + K]
        step, *_ = np.linalg.lstsq(jacobian, -residuals, rcond=None)
        pos += step[:3]
        biases += step[3:]
        if np.abs(step[:3]).max() < 1e-4 and np.abs(step[3:]).max() * C < 1e-4:
            break  # converged (see solve_position)
    return pos, biases


def dilution_of_precision(
    sat_positions: np.ndarray, receiver_ecef: np.ndarray
) -> dict[str, float]:
    """Geometry quality of a fix: G/P/T DOP from the unit-line-of-sight
    design matrix (standard GNSS definition; the reference reports none).
    GDOP < 2 is excellent geometry; > 6 means the solution is
    geometry-limited regardless of measurement quality."""
    los = np.asarray(sat_positions, dtype=np.float64) - np.asarray(receiver_ecef)[None, :]
    e = los / np.linalg.norm(los, axis=1, keepdims=True)
    g = np.concatenate([e, np.ones((e.shape[0], 1))], axis=1)  # [N, 4]
    try:
        q = np.linalg.inv(g.T @ g)
    except np.linalg.LinAlgError:
        # Degenerate geometry (e.g. all satellites on one cone): the DOP is
        # unbounded; report infinities rather than failing the fix.
        inf = float("inf")
        return {"gdop": inf, "pdop": inf, "tdop": inf,
                "hdop": inf, "vdop": inf}
    d = np.diag(q)
    # Horizontal/vertical split: rotate the position block of the cofactor
    # into the local ENU frame (NMEA's GGA/GSA report HDOP/VDOP, not PDOP).
    from gypsum_tpu_torch.solve.geodesy import enu_basis

    r = enu_basis(receiver_ecef)  # rows = east, north, up
    q_enu = r @ q[:3, :3] @ r.T
    return {
        "gdop": float(np.sqrt(d.sum())),
        "pdop": float(np.sqrt(d[:3].sum())),
        "tdop": float(np.sqrt(d[3])),
        "hdop": float(np.sqrt(max(q_enu[0, 0] + q_enu[1, 1], 0.0))),
        "vdop": float(np.sqrt(max(q_enu[2, 2], 0.0))),
    }
