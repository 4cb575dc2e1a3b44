"""Navigation extended Kalman filter: coasting through satellite outages.

The reference receiver (gypsum/world_model.py:567-589) and the per-epoch
least-squares solver (solve/fix.py) both need >= 4 satellites with fresh
handover words; drop below four and the receiver goes dark until
re-acquisition. A production receiver bridges such outages with a
navigation filter: this module maintains an 8-state EKF

    x = [ p (ECEF, m, 3) | v (ECEF, m/s, 3) | cb (m) | cd (m/s) ]

(clock bias and drift expressed in meters / meters-per-second, i.e.
multiplied by c) under a constant-velocity + two-state-clock process
model, updated by whatever pseudorange and range-rate (Doppler)
measurements exist each epoch -- one, two, three or ten. While >= 4
satellites are available the filter shadows the least-squares fix (which
stays the published primary -- its accuracy is campaign-gated); when the
count drops below four the filter keeps producing position solutions from
the remaining measurements, with honestly growing covariance, until its
predicted position standard deviation exceeds the configured publishing
gate.

Measurement models (e = unit vector receiver -> satellite):

    pseudorange   z = |s - p| + cb            H_p = -e,  H_cb = 1
    range rate    z = e . (v_sv - v) + cd     H_v = -e,  H_cd = 1

with z_rr = -lambda * f_doppler (same sign convention proven end-to-end by
solve/velocity.py). Updates are sequential scalar (R is diagonal), each
gated at ``gate_sigma`` standard deviations of its innovation, with the
covariance kept symmetric in Joseph form.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GPS_L1_FREQUENCY_HZ,
    SPEED_OF_LIGHT_M_PER_S as C,
)

WAVELENGTH_M = C / GPS_L1_FREQUENCY_HZ


@dataclass
class EkfTuning:
    """Process / measurement noise knobs (defaults sized for a pedestrian
    or slow-vehicle receiver with a TCXO-grade clock)."""

    accel_sigma_mps2: float = 0.5  # white-accel PSD^0.5 per ECEF axis
    clock_bias_rw_m: float = 0.5  # bias random walk, m / sqrt(s)
    clock_drift_rw_mps: float = 0.05  # drift random walk, (m/s) / sqrt(s)
    pr_sigma_m: float = 3.0  # pseudorange measurement noise
    rr_sigma_mps: float = 0.15  # range-rate measurement noise
    gate_sigma: float = 6.0  # innovation gate, in sigmas
    # Initial uncertainties when seeding from a least-squares fix.
    init_pos_sigma_m: float = 10.0
    init_vel_sigma_mps: float = 1.0
    init_cb_sigma_m: float = 10.0
    init_cd_sigma_mps: float = 1.0


@dataclass
class EkfUpdateStats:
    """What one epoch's update actually used (observability surface)."""

    n_pr_used: int = 0
    n_pr_rejected: int = 0
    n_rr_used: int = 0
    n_rr_rejected: int = 0


@dataclass
class NavigationEKF:
    tuning: EkfTuning = field(default_factory=EkfTuning)
    x: np.ndarray | None = None  # [8]
    P: np.ndarray | None = None  # [8, 8]
    t: float | None = None  # receiver timestamp of the state

    @property
    def initialized(self) -> bool:
        return self.x is not None

    @property
    def position(self) -> np.ndarray:
        return self.x[0:3]

    @property
    def velocity(self) -> np.ndarray:
        return self.x[3:6]

    @property
    def position_sigma_m(self) -> float:
        """RSS standard deviation of the position estimate."""
        return float(np.sqrt(np.trace(self.P[0:3, 0:3])))

    def initialize(
        self,
        t: float,
        position_ecef: np.ndarray,
        velocity_ecef: np.ndarray | None = None,
        clock_bias_m: float = 0.0,
        clock_drift_mps: float = 0.0,
    ) -> None:
        tun = self.tuning
        self.x = np.zeros(8)
        self.x[0:3] = np.asarray(position_ecef, dtype=np.float64)
        if velocity_ecef is not None:
            self.x[3:6] = np.asarray(velocity_ecef, dtype=np.float64)
        self.x[6] = clock_bias_m
        self.x[7] = clock_drift_mps
        self.P = np.diag(
            [tun.init_pos_sigma_m**2] * 3
            + [tun.init_vel_sigma_mps**2] * 3
            + [tun.init_cb_sigma_m**2, tun.init_cd_sigma_mps**2]
        )
        self.t = float(t)

    # ------------------------------------------------------------- predict

    def predict(self, t: float) -> None:
        """Propagate the state to receiver timestamp ``t``."""
        dt = float(t) - self.t
        if dt <= 0.0:
            self.t = float(t)
            return
        tun = self.tuning
        f = np.eye(8)
        f[0, 3] = f[1, 4] = f[2, 5] = dt
        f[6, 7] = dt
        self.x = f @ self.x
        # Continuous white-noise acceleration, exactly discretized per axis;
        # the clock pair uses the same two-state form with independent bias
        # and drift random walks.
        qa = tun.accel_sigma_mps2**2
        q = np.zeros((8, 8))
        for i in range(3):
            q[i, i] = qa * dt**3 / 3.0
            q[i, i + 3] = q[i + 3, i] = qa * dt**2 / 2.0
            q[i + 3, i + 3] = qa * dt
        qd = tun.clock_drift_rw_mps**2
        q[6, 6] = tun.clock_bias_rw_m**2 * dt + qd * dt**3 / 3.0
        q[6, 7] = q[7, 6] = qd * dt**2 / 2.0
        q[7, 7] = qd * dt
        self.P = f @ self.P @ f.T + q
        self.t = float(t)

    # -------------------------------------------------------------- update

    def _scalar_update(self, z: float, h: float, H: np.ndarray, r: float) -> bool:
        """One gated scalar measurement; returns True if accepted."""
        innov = z - h
        s = float(H @ self.P @ H + r)
        if innov * innov > self.tuning.gate_sigma**2 * s:
            return False
        k = (self.P @ H) / s  # [8]
        self.x = self.x + k * innov
        ikh = np.eye(8) - np.outer(k, H)
        self.P = ikh @ self.P @ ikh.T + np.outer(k, k) * r  # Joseph form
        self.P = 0.5 * (self.P + self.P.T)
        return True

    def update(
        self,
        sat_positions: np.ndarray,  # [N, 3] ECEF m
        pseudoranges_m: np.ndarray | None = None,  # [N] corrected, = C * transit
        sat_velocities: np.ndarray | None = None,  # [N, 3] ECEF m/s
        dopplers_hz: np.ndarray | None = None,  # [N]
    ) -> EkfUpdateStats:
        """Sequential scalar update with whatever measurements exist.

        ``pseudoranges_m`` must already carry the atmospheric corrections
        (the world model applies Klobuchar/Saastamoinen to the transit
        times before c-scaling, solve/world.py). Range-rate rows require
        both ``sat_velocities`` and ``dopplers_hz``.
        """
        sat_positions = np.asarray(sat_positions, dtype=np.float64)
        stats = EkfUpdateStats()
        n = sat_positions.shape[0]
        for i in range(n):
            los = sat_positions[i] - self.x[0:3]
            rho = float(np.linalg.norm(los))
            e = los / rho
            if pseudoranges_m is not None:
                H = np.zeros(8)
                H[0:3] = -e
                H[6] = 1.0
                ok = self._scalar_update(
                    float(pseudoranges_m[i]),
                    rho + self.x[6],
                    H,
                    self.tuning.pr_sigma_m**2,
                )
                stats.n_pr_used += ok
                stats.n_pr_rejected += not ok
            if dopplers_hz is not None and sat_velocities is not None:
                # rho_dot = e . (v_sv - v_rx); z = -lambda f = rho_dot + cd.
                H = np.zeros(8)
                H[3:6] = -e
                H[7] = 1.0
                h = float(e @ (np.asarray(sat_velocities[i]) - self.x[3:6])) + self.x[7]
                ok = self._scalar_update(
                    -WAVELENGTH_M * float(dopplers_hz[i]),
                    h,
                    H,
                    self.tuning.rr_sigma_mps**2,
                )
                stats.n_rr_used += ok
                stats.n_rr_rejected += not ok
        return stats
