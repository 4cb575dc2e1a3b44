"""Dual-antenna GNSS attitude: heading/pitch from a rigid carrier-phase
baseline.

Two antennas a known distance apart on a rigid body give a per-epoch
carrier-phase baseline whose DIRECTION is the body's attitude (heading =
azimuth of the antenna-1 -> antenna-2 axis, pitch = its elevation). The
known antenna separation is an extra scalar observable the free-baseline
RTK solver does not have, and this module uses it the way production
attitude receivers do:

- as a geometric VALIDATION of the integer ambiguity fix (a wrong integer
  vector displaces every epoch's baseline by decimeters, so its implied
  length is wrong by far more than the carrier noise), and
- as an ARBITER between integer candidates when the plain ratio test is
  indecisive (short observation windows / few satellites): among the best
  ILS candidates, only the true one yields per-epoch baseline lengths that
  sit at the known separation across the whole window.

Built on the kinematic RTK engine (solve/rtk.py:_kinematic_float /
_fixed_epoch_positions). reference: no counterpart — gypsum's solver is a
single-receiver, meter-level code solver (gypsum/world_model.py); attitude
is framework-original capability.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GPS_L1_FREQUENCY_HZ,
    SPEED_OF_LIGHT_M_PER_S as SPEED_OF_LIGHT,
)
from gypsum_tpu_torch.solve.geodesy import enu_basis
from gypsum_tpu_torch.solve.rtk import (
    DDObservations,
    _fixed_epoch_positions,
    _kinematic_float,
    bootstrap_success_rate,
    integer_least_squares,
)


def heading_pitch_of(baseline_ecef: np.ndarray, ref_ecef: np.ndarray):
    """Heading (deg clockwise from true north, [0, 360)) and pitch (deg,
    positive up) of a baseline vector, in the local ENU frame at ``ref_ecef``.

    Accepts a single [3] vector or a stack [..., 3]; returns arrays of the
    leading shape (scalars for a single vector).
    """
    b = np.asarray(baseline_ecef, np.float64)
    east, north, up = enu_basis(np.asarray(ref_ecef, np.float64))
    e = b @ east
    n = b @ north
    u = b @ up
    heading = np.degrees(np.arctan2(e, n)) % 360.0
    pitch = np.degrees(np.arctan2(u, np.hypot(e, n)))
    if b.ndim == 1:
        return float(heading), float(pitch)
    return heading, pitch


@dataclass
class AttitudeSolution:
    epochs_s: np.ndarray        # [T]
    heading_deg: np.ndarray     # [T] of the antenna1 -> antenna2 axis
    pitch_deg: np.ndarray       # [T]
    baselines_m: np.ndarray     # [T, 3] ECEF, the baselines behind the angles
    length_m: np.ndarray        # [T] per-epoch |baseline|
    length_rms_m: float         # rms(|b_t| - known separation)
    fixed: bool
    fixed_by: str | None        # 'ratio' | 'length' | None
    mount_alarm: bool           # phases fixed decisively but geometry refused
    ratio: float                # ILS second-best / best cost
    length_ratio: float         # runner-up / best length-rms (noise-floored)
    sigma_length_m: float       # formal per-epoch 1-sigma of |baseline|
    sigma_heading_deg: np.ndarray  # [T] formal per-epoch 1-sigma of heading
    sigma_pitch_deg: np.ndarray    # [T] formal per-epoch 1-sigma of pitch
    ambiguities: np.ndarray | None
    n_length_consistent: int    # ILS candidates passing the length gate
    prns: list
    ref_prn: int


def solve_attitude(
    dd: DDObservations,
    sv_pos_fn,
    antenna1_ecef: np.ndarray,
    separation_m: float,
    sigma_phase_half_cycles: float = 0.02,
    sigma_code_m: float = 1.0,
    ratio_threshold: float = 2.0,
    min_bootstrap_success: float = 0.99,
    length_tolerance_m: float = 0.03,
    length_ratio_threshold: float = 3.0,
    n_candidates: int = 24,
) -> AttitudeSolution:
    """Per-epoch heading/pitch of the antenna-1 -> antenna-2 axis.

    ``dd`` are the double differences with antenna 1 as "base" and antenna 2
    as "rover" (rtk.form_double_differences); ``separation_m`` is the known
    rigid antenna separation. Satellite geometry is evaluated at antenna 1's
    position — for meter-scale separations the direction error this causes
    scales by separation/range (~1e-7), micro-degrees.

    Fix logic: the best ``n_candidates`` ILS integer vectors are each turned
    into per-epoch fixed baselines and scored by rms(|b_t| - separation).
    The fix is accepted either when the standard dual gate (ratio +
    bootstrap) passes AND the ILS-best candidate clears the absolute length
    gate (``fixed_by='ratio'``), or by LENGTH ARBITRATION (``fixed_by=
    'length'``) when the rigid geometry is decisive where the ratio test
    alone was not. Arbitration requires ALL of: >= 4 DDs (with 3 the
    per-epoch fixed solve has zero phase redundancy, so a wrong candidate
    can fit both the phases and the length sphere exactly); best rms under
    the absolute gate AND statistically consistent (< 4x the formal length
    sigma — the true candidate sits AT that sigma, an impostor that merely
    grazed the sphere does not); and the runner-up worse by
    ``length_ratio_threshold``, measured against max(best rms, sigma) so a
    sub-noise rms cannot claim a decisive win. Each of these closes a wrong-
    fix mode observed in tools/attitude_study.py's Monte-Carlo (tolerance-
    only gating published ~3% wrong attitudes on short windows; the full
    gate set publishes none while still rescuing the majority).

    Ratio-pass + length-fail is a MOUNT-MODEL ALARM, not an arbitration
    case: when the phase data decisively pick an integer vector (ratio +
    bootstrap pass) whose implied baseline length contradicts the claimed
    separation, the two halves of the model disagree — the likely causes
    are a wrong claimed separation or a non-rigid mount, and under either
    the length information is exactly what cannot be trusted to arbitrate a
    DIFFERENT candidate. The solve refuses outright (``fixed=False``,
    ``mount_alarm=True``) rather than falling through to length
    arbitration.

    Direction uncertainty: per-epoch formal 1-sigma heading/pitch
    (``sigma_heading_deg``/``sigma_pitch_deg``) are published alongside the
    angles — the tangential analogue of ``sigma_length_m``. They scale as
    phase-noise / separation: a 0.5 m arm at 1 mm phase noise is ~0.1 deg,
    but weak epochs or short separations can reach degrees, so consumers
    should read the sigma, not assume a fixed quality.
    """
    antenna1_ecef = np.asarray(antenna1_ecef, np.float64)
    X, a, Q_a, geometry = _kinematic_float(
        dd, sv_pos_fn, antenna1_ecef, sigma_phase_half_cycles, sigma_code_m)

    cands, costs = integer_least_squares(a, Q_a, n_cand=n_candidates)
    ratio = float(costs[1] / max(costs[0], 1e-12)) if len(costs) > 1 else np.inf
    boot_ok = bootstrap_success_rate(Q_a) >= min_bootstrap_success

    # Score every candidate by how well its per-epoch baseline lengths sit
    # at the known separation.
    per_cand = []
    for z in cands:
        Xf = _fixed_epoch_positions(dd, geometry, X, z,
                                    sigma_phase_half_cycles, sigma_code_m)
        b = Xf - antenna1_ecef
        lengths = np.linalg.norm(b, axis=1)
        rms = float(np.sqrt(np.mean((lengths - separation_m) ** 2)))
        per_cand.append((z, b, lengths, rms))
    consistent = [c for c in per_cand if c[3] < length_tolerance_m]
    by_rms = sorted(per_cand, key=lambda c: c[3])

    # Formal per-epoch 1-sigma of the baseline LENGTH (the radial component
    # of the fixed-solve covariance): the TRUE candidate's length rms sits
    # at this floor, so an rms "win" below it is noise, not information —
    # the margin test saturates here. Without the floor, a 3-DD short
    # window where the true rms is noise-dominated (~2 cm) can lose to an
    # impostor that lands on the length sphere at millimeters
    # (tools/attitude_study.py trial that motivated this).
    w_p = 1.0 / sigma_phase_half_cycles
    w_c = 1.0 / sigma_code_m
    scale = 2.0 * GPS_L1_FREQUENCY_HZ / SPEED_OF_LIGHT
    _, H = geometry(X)
    b_float = X - antenna1_ecef
    east_ax, north_ax, up_ax = enu_basis(antenna1_ecef)
    sig, sig_heading, sig_pitch = [], [], []
    for t in range(len(dd.epochs_s)):
        At = np.concatenate([-scale * H[t] * w_p, H[t] * w_c])
        C = np.linalg.inv(At.T @ At)
        bt = b_float[t]
        u = bt / max(np.linalg.norm(bt), 1e-9)
        sig.append(float(np.sqrt(u @ C @ u)))
        # Tangential analogues: propagate C through the heading/pitch maps.
        # heading = atan2(e, n); pitch = atan2(up, hypot(e, n)).
        e, n, up_c = bt @ east_ax, bt @ north_ax, bt @ up_ax
        h2 = max(e * e + n * n, 1e-18)
        g_head = (n * east_ax - e * north_ax) / h2
        h = np.sqrt(h2)
        r2 = max(h2 + up_c * up_c, 1e-18)
        g_pitch = (h * up_ax - (up_c / h) * (e * east_ax + n * north_ax)) / r2
        sig_heading.append(float(np.degrees(np.sqrt(g_head @ C @ g_head))))
        sig_pitch.append(float(np.degrees(np.sqrt(g_pitch @ C @ g_pitch))))
    sigma_length = float(np.mean(sig))

    length_ratio = (by_rms[1][3] / max(by_rms[0][3], sigma_length, 1e-9)
                    if len(by_rms) > 1 else np.inf)

    best = per_cand[0]
    m1 = len(dd.prns)
    fixed_by: str | None = None
    mount_alarm = False
    ratio_ok = ratio >= ratio_threshold and boot_ok
    if ratio_ok and best[3] < length_tolerance_m:
        fixed_by = "ratio"
        chosen = best
    elif ratio_ok:
        # Phases decisively fixed an integer vector whose implied baseline
        # length contradicts the claimed separation: the mount model itself
        # is suspect (wrong separation / flexing arm), so the length cannot
        # be trusted to arbitrate a DIFFERENT candidate. Refuse outright.
        mount_alarm = True
        bf = X - antenna1_ecef
        chosen = (None, bf, np.linalg.norm(bf, axis=1),
                  float(np.sqrt(np.mean(
                      (np.linalg.norm(bf, axis=1) - separation_m) ** 2))))
    elif (
        # Length arbitration needs phase redundancy: with only 3 DDs each
        # epoch's fixed solve has 3 unknowns and 3 phase rows, so a wrong
        # candidate can fit BOTH the phases and the length sphere exactly
        # (the Monte-Carlo's one unfixable wrong case). >= 4 DDs (5 SVs)
        # leaves per-epoch residuals that expose impostors.
        m1 >= 4
        and by_rms[0][3] < length_tolerance_m
        # The winner must itself be statistically consistent: the true
        # candidate's rms sits AT the formal sigma, so an rms many sigma
        # above it is an impostor that merely grazed the sphere.
        and by_rms[0][3] < 4.0 * sigma_length
        and length_ratio >= length_ratio_threshold
    ):
        fixed_by = "length"
        chosen = by_rms[0]
    else:
        # Unfixed: publish the float baselines (decimeter-class direction).
        bf = X - antenna1_ecef
        chosen = (None, bf, np.linalg.norm(bf, axis=1),
                  float(np.sqrt(np.mean(
                      (np.linalg.norm(bf, axis=1) - separation_m) ** 2))))

    z_fix, b, lengths, rms = chosen
    heading, pitch = heading_pitch_of(b, antenna1_ecef)
    return AttitudeSolution(
        epochs_s=dd.epochs_s,
        heading_deg=np.asarray(heading),
        pitch_deg=np.asarray(pitch),
        baselines_m=b,
        length_m=lengths,
        length_rms_m=rms,
        fixed=fixed_by is not None,
        fixed_by=fixed_by,
        mount_alarm=mount_alarm,
        ratio=ratio,
        length_ratio=float(length_ratio),
        sigma_length_m=sigma_length,
        sigma_heading_deg=np.asarray(sig_heading),
        sigma_pitch_deg=np.asarray(sig_pitch),
        ambiguities=None if z_fix is None else z_fix.astype(np.int64),
        n_length_consistent=len(consistent),
        prns=list(dd.prns),
        ref_prn=dd.ref_prn,
    )
