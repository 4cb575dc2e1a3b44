"""Dual-receiver carrier-phase differential positioning (RTK baseline).

Beyond-reference capability: the reference is a single-receiver code-phase
receiver (its best case is meter-level, gypsum/world_model.py:567-633). This
module solves the centimeter-level *baseline* between two receivers tracking
the same satellites, from double-differenced carrier phase with integer
ambiguity resolution — the standard RTK measurement model, built on this
framework's tracker outputs with no new device work.

Observables
-----------
The tracker's NCO phase tracks the incoming baseband carrier phase, which the
synthesizer models as exactly ``-2 pi f_L1 tau_phase(t)``
(signal/constellation.py:438). The per-ms update law is

    theta[k+1] = mod(theta[k] + 2 pi f_d[k] t_ms + kp(locked[k]) pll_err[k], 2 pi)

(track/loop.py:373-375, track/matmul.py:254-256), and every quantity on the
right is exported per ms in ``ChannelObservation``, so the *accumulated*
(unwrapped) carrier phase is reconstructed on host exactly: the f64 replay of
the update counts whole turns, then each sample is pinned back to the
device's own wrapped value, leaving zero reconstruction error beyond the
kernel's f32 rounding (~1e-3 rad per block, checked).

Because the Costas discriminator is invariant under a pi rotation, the
carrier ambiguity lives on the HALF-cycle lattice: all ambiguities here are
integers in units of lambda/2 = c / (2 f_L1) ~ 9.52 cm.

Double differences
------------------
For base b (known position), rover v, satellites s and reference satellite r:

    DD_phi = (phi_v^s - phi_b^s) - (phi_v^r - phi_b^r)
           = -(2 f/c) * DD_rho + a,     a integer (half-cycles)
    DD_code = DD_rho + noise            (meters, from sub-sample code phases,
                                         wrapped to +/-0.5 ms * c)

Receiver clocks, satellite clocks and (over short baselines) atmosphere all
cancel. ``DD_rho(x_v) = (rho_v^s - rho_b^s) - (rho_v^r - rho_b^r)``.

Estimation
----------
Float: Gauss-Newton on stacked phase+code rows over all epochs for
[baseline (3), ambiguities (m-1)]. Integer fixing: LAMBDA-style LtDL
decorrelation (integer Gauss transforms + symmetric permutations) followed by
an exact depth-first integer-least-squares search returning the two best
candidates for the ratio test. Fixed: Gauss-Newton re-solve of the baseline
with ambiguities held at the integers.

Epoch alignment: both logs index epochs by integer stream milliseconds. Two
modes:

- Shared time base (default): simultaneous captures of the same scene
  (e.g. two channels of one ADC clock) are differenced sample-for-sample.
- Independent clocks: when the receivers sample on their own oscillators
  (start offset + relative drift), pass a ``StreamAlignment`` to
  ``form_double_differences``. The alignment is measured from the
  observables themselves by ``estimate_stream_alignment`` — sub-ms offset
  from the single-difference code (geometry contributes only baseline/c
  <= 50 ns over short baselines), relative drift from the common
  single-difference carrier slope (the LO term, identical on every
  satellite) — and the whole-ms/seconds part from each receiver's decoded
  time base (world-model clock slide). Rover observables are then
  interpolated onto the base epochs' GPS instants: unwrapped carrier phase
  and unwrapped code delay are both smooth in time (slopes ~Doppler and
  ~range-rate/c), so linear interpolation on the 1 kHz grid costs
  micro-cycles. A residual alignment error dt mis-cancels Doppler as
  f_d * dt per satellite: the estimator's ~0.1 us keeps that below the
  tracker's own phase noise.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ, SPEED_OF_LIGHT_M_PER_S as SPEED_OF_LIGHT
from gypsum_tpu_torch.core.config import TrackingConfig

_logger = logging.getLogger(__name__)

_TWO_PI = 2.0 * np.pi
#: Half-cycle wavelength (m): the Costas ambiguity unit.
HALF_CYCLE_M = SPEED_OF_LIGHT / (2.0 * GPS_L1_FREQUENCY_HZ)


# --------------------------------------------------------------------------
# Carrier phase accumulation
# --------------------------------------------------------------------------


@dataclass
class PhaseArc:
    """One continuous-lock span of a channel's carrier phase."""

    prn: int
    ms: list[int] = field(default_factory=list)  # integer stream-ms epochs
    phase_cycles: list[float] = field(default_factory=list)  # accumulated NCO / 2pi
    code_delay_s: list[float] = field(default_factory=list)  # sub-ms code delay
    locked: list[bool] = field(default_factory=list)


class CarrierPhaseLog:
    """Accumulates unwrapped carrier phase + code observables per channel.

    Feed every ``ChannelObservation`` (in block order per PRN); attach to a
    receiver with ``receiver.add_block_listener(log.listener())``. A block
    whose wrapped start phase does not chain from the previous block's end
    (host-side state edits: rescue nudges, slot reassignment) starts a new
    arc — a new ambiguity.
    """

    def __init__(self, sample_rate: float, samples_per_prn: int,
                 cfg: TrackingConfig | None = None) -> None:
        cfg = cfg or TrackingConfig()
        self.fs = float(sample_rate)
        self.spp = int(samples_per_prn)
        self.t_ms = self.spp / self.fs
        zeta = cfg.pll_damping_factor
        # Same gain law as the tracker (track/matmul.py:88-94).
        self.kp_locked = 4.0 * zeta * cfg.pll_bandwidth_locked_hz * self.t_ms
        self.kp_pullin = 4.0 * zeta * cfg.pll_bandwidth_pullin_hz * self.t_ms
        self.arcs: dict[int, list[PhaseArc]] = {}
        # per-PRN (expected wrapped phase at next block start, accumulated end)
        self._chain: dict[int, tuple[float, float]] = {}
        #: worst |reconstructed - device wrapped| residual seen (rad); a
        #: self-check that the host replay matches the kernel's arithmetic.
        self.max_pin_residual_rad = 0.0

    def listener(self):
        def _on_block(_recv, report) -> None:
            for obs in report.observations:
                self.ingest(obs)

        return _on_block

    def ingest(self, obs) -> None:
        th = np.asarray(obs.carrier_phases, np.float64)  # wrapped, [B]
        fd = np.asarray(obs.dopplers, np.float64)
        pe = np.asarray(obs.pll_errors, np.float64)
        locked = np.asarray(obs.locked, bool)
        b = th.shape[0]
        kp = np.where(locked, self.kp_locked, self.kp_pullin)
        dth = _TWO_PI * fd * self.t_ms + kp * pe  # phase advance of ms k
        # f64 replay of the NCO counts whole turns ...
        acc = th[0] + np.concatenate(([0.0], np.cumsum(dth[:-1])))
        # ... then pin every sample to the device's own wrapped value.
        turns = np.round((acc - th) / _TWO_PI)
        pinned = th + _TWO_PI * turns
        resid = float(np.max(np.abs(pinned - acc)))
        if resid > self.max_pin_residual_rad:
            self.max_pin_residual_rad = resid
        if resid > 1.0:  # way beyond f32 rounding: the replay went wrong
            _logger.warning("PRN %d: phase pin residual %.3f rad", obs.prn, resid)
        acc = pinned
        acc_end = acc[-1] + dth[-1]

        # Stream-ms epoch of theta[k]: start_times are code-corrected
        # (track/loop.py:824), so subtract the correction back out.
        t0 = float(obs.start_times[0]) - float(obs.code_phases[0]) / self.fs
        ms0 = int(round(t0 * 1e3))

        arcs = self.arcs.setdefault(obs.prn, [])
        chain = self._chain.get(obs.prn)
        cont = False
        if chain is not None and arcs:
            exp_wrapped, acc_prev_end = chain
            d = (th[0] - exp_wrapped + np.pi) % _TWO_PI - np.pi
            if abs(d) < 0.1 and arcs[-1].ms and ms0 == arcs[-1].ms[-1] + 1:
                cont = True
                acc = acc - acc[0] + acc_prev_end + d
                acc_end = acc[-1] + dth[-1]
        arc = arcs[-1] if cont else PhaseArc(prn=obs.prn)
        if not cont:
            arcs.append(arc)
        arc.ms.extend(range(ms0, ms0 + b))
        arc.phase_cycles.extend((acc / _TWO_PI).tolist())
        arc.code_delay_s.extend(
            (np.asarray(obs.code_phases_measured, np.float64) / self.fs).tolist()
        )
        arc.locked.extend(locked.tolist())
        self._chain[obs.prn] = (float(acc_end % _TWO_PI), float(acc_end))

    def longest_arc(self, prn: int) -> PhaseArc | None:
        arcs = self.arcs.get(prn)
        if not arcs:
            return None
        return max(arcs, key=lambda a: len(a.ms))


# --------------------------------------------------------------------------
# Stream alignment (independent receiver clocks)
# --------------------------------------------------------------------------


@dataclass
class StreamAlignment:
    """Affine map between two receivers' sample-stream time bases.

    The GPS instant sampled at rover stream time ``r_v`` was sampled at base
    stream time ``r_b = offset_s + (1 + drift) * r_v``. ``offset_s`` is the
    base stream time of the rover's first sample; ``drift`` is the relative
    oscillator rate (base minus rover fractional frequency error).
    """

    offset_s: float
    drift: float
    sigma_offset_s: float  # scatter of the per-epoch code offsets (s)
    n_satellites: int

    def base_time_of(self, r_rover_s: float) -> float:
        return self.offset_s + (1.0 + self.drift) * r_rover_s

    def rover_time_of(self, r_base_s):
        return (np.asarray(r_base_s) - self.offset_s) / (1.0 + self.drift)


#: Zero alignment: both captures share one sample clock (the default mode).
SHARED_CLOCK = StreamAlignment(0.0, 0.0, 0.0, 0)


def estimate_stream_alignment(
    base: CarrierPhaseLog,
    rover: CarrierPhaseLog,
    prns: list[int] | None = None,
    coarse_offset_s: float = 0.0,
    epoch_every_ms: int = 250,
    settle_ms: int = 2000,
    sd_range_fn=None,
) -> StreamAlignment:
    """Measure the rover->base stream time map from the observables alone.

    - Relative drift: every satellite's single-difference carrier slides at
      ``-f_L1 * (d_rover - d_base)`` (the LO term is common to all
      satellites); the cross-satellite median of per-SV phase slopes rejects
      the small geometry-driven terms.
    - Sub-ms offset: the single-difference code delay is
      ``(tau_v - tau_b) - delta(t)  (mod 1 ms)`` where ``delta`` is the
      stream offset; window-medians over epochs give it to ~0.1 us. The
      geometry term ``tau_v - tau_b`` is baseline/c (< 50 ns over short
      baselines); pass ``sd_range_fn(prn, t_base_s) -> meters`` (e.g. from
      each receiver's own code fix) to remove it on longer baselines.
    - Whole milliseconds/seconds: NOT observable from wrapped code — supply
      ``coarse_offset_s`` (e.g. the difference of the two receivers' decoded
      clock slides, accurate to well under 0.5 ms).
    """
    k0 = int(round(coarse_offset_s * 1e3))  # whole-ms part, base-ms units
    avail = sorted(set(base.arcs) & set(rover.arcs))
    prns = [p for p in (prns or avail) if p in avail]
    if not prns:
        raise ValueError("no common satellites to align on")

    per: dict[int, dict[int, tuple]] = {}
    for p in prns:
        ab, ar = base.longest_arc(p), rover.longest_arc(p)
        mb = {m: i for i, m in enumerate(ab.ms)}
        series = {}
        for i_r, m in enumerate(ar.ms):
            i_b = mb.get(m + k0)
            if i_b is None or not (ab.locked[i_b] and ar.locked[i_r]):
                continue
            series[m] = (
                ar.phase_cycles[i_r] - ab.phase_cycles[i_b],
                ar.code_delay_s[i_r] - ab.code_delay_s[i_b],
            )
        if len(series) >= 3:
            per[p] = series
    if not per:
        raise ValueError(
            "no overlapping locked spans after the coarse shift "
            f"({k0} ms) — is coarse_offset_s right?"
        )
    prns = sorted(per)
    common = set.intersection(*(set(s) for s in per.values()))
    common = sorted(m for m in common if m >= settle_ms)[::epoch_every_ms]
    if len(common) < 3:
        raise ValueError("fewer than 3 common locked epochs for alignment")

    t = np.array(common, np.float64) * 1e-3  # rover stream seconds
    half = epoch_every_ms // 2

    # Drift from the common carrier slope (see module docstring for signs:
    # time_transfer's drift_carrier = d_rover - d_base = -median/f_L1, and
    # this map needs d_base - d_rover).
    phase_sd = np.array(
        [[per[p][m][0] for p in prns] for m in common]
    )  # [T, P] cycles
    ph_slopes = np.polyfit(t - t[0], phase_sd, 1)[0]  # [P] cycles/s
    drift = float(np.median(ph_slopes) / GPS_L1_FREQUENCY_HZ)

    # Sub-ms offset from window-medians of the SD code, geometry removed if
    # the caller can predict it, drift slope removed, wrapped to +/-0.5 ms.
    deltas = np.empty((len(common), len(prns)))
    for j, p in enumerate(prns):
        for i, m in enumerate(common):
            vals = np.array([
                per[p][k][1]
                for k in range(m - half, m + half + 1)
                if k in per[p]
            ])
            vals = vals[0] + _wrap_ms(vals - vals[0])
            sd_code = float(np.median(vals))
            if sd_range_fn is not None:
                sd_code -= sd_range_fn(p, coarse_offset_s + t[i]) / SPEED_OF_LIGHT
            deltas[i, j] = -sd_code
    # Each satellite's raw SD code sits on its own 1 ms branch; re-center
    # every column to the first column's branch before the cross-SV median.
    deltas = deltas[:, :1] + _wrap_ms(deltas - deltas[:, :1])
    delta_series = np.median(deltas, axis=1)  # [T]
    resid = delta_series - drift * t
    # All residuals live within one wrap of the first: re-center then wrap.
    resid = resid[0] + _wrap_ms(resid - resid[0])
    offset_sub = float(np.median(resid))
    sigma = float(np.std(resid - offset_sub))
    offset = k0 * 1e-3 + float(_wrap_ms(np.array([offset_sub]))[0])
    return StreamAlignment(
        offset_s=offset, drift=drift, sigma_offset_s=sigma,
        n_satellites=len(prns),
    )


def _unwrap_code_delay(cd: np.ndarray) -> np.ndarray:
    """Sub-ms code delays -> continuous series (rate ~range-rate/c, us/s)."""
    return cd[0] + np.concatenate(([0.0], np.cumsum(_wrap_ms(np.diff(cd)))))


def _sd_series_aligned(
    ab: "PhaseArc", ar: "PhaseArc", alignment: StreamAlignment
) -> dict[int, tuple]:
    """Single differences keyed by BASE stream ms, the rover's unwrapped
    phase and code delay linearly interpolated to each base epoch's GPS
    instant. Requires both bracketing rover samples locked and adjacent
    (1 ms apart) — gaps or unlock spans simply drop those epochs."""
    t_v = np.asarray(ar.ms, np.float64) * 1e-3
    ph_v = np.asarray(ar.phase_cycles, np.float64)
    cd_v = _unwrap_code_delay(np.asarray(ar.code_delay_s, np.float64))
    lk_v = np.asarray(ar.locked, bool)

    ms_b = np.asarray(ab.ms, np.int64)
    r_v = alignment.rover_time_of(ms_b * 1e-3)  # rover stream seconds
    j = np.searchsorted(t_v, r_v)  # t_v[j-1] <= r_v < t_v[j]
    ok = (j > 0) & (j < len(t_v)) & np.asarray(ab.locked, bool)
    j = np.clip(j, 1, max(len(t_v) - 1, 1))
    ok &= lk_v[j - 1] & lk_v[j] & (t_v[j] - t_v[j - 1] < 1.5e-3)
    w = np.clip((r_v - t_v[j - 1]) / np.maximum(t_v[j] - t_v[j - 1], 1e-12), 0, 1)
    ph_i = ph_v[j - 1] * (1 - w) + ph_v[j] * w
    cd_i = cd_v[j - 1] * (1 - w) + cd_v[j] * w

    ph_b = np.asarray(ab.phase_cycles, np.float64)
    cd_b = np.asarray(ab.code_delay_s, np.float64)
    return {
        int(m): (ph_i[i] - ph_b[i], cd_i[i] - cd_b[i])
        for i, m in enumerate(ms_b)
        if ok[i]
    }


# --------------------------------------------------------------------------
# Double differences
# --------------------------------------------------------------------------


@dataclass
class DDObservations:
    prns: list[int]  # non-reference satellites, order of the DD columns
    ref_prn: int
    epochs_s: np.ndarray  # [T] stream seconds
    phase_half_cycles: np.ndarray  # [T, m-1]
    code_m: np.ndarray  # [T, m-1]


def _wrap_ms(x: np.ndarray) -> np.ndarray:
    return (x + 0.5e-3) % 1e-3 - 0.5e-3


def form_double_differences(
    base: CarrierPhaseLog,
    rover: CarrierPhaseLog,
    prns: list[int] | None = None,
    ref_prn: int | None = None,
    epoch_every_ms: int = 250,
    settle_ms: int = 2000,
    alignment: StreamAlignment | None = None,
) -> DDObservations:
    """Common-epoch double differences from two receivers' longest arcs.

    With ``alignment`` (independent receiver clocks, see
    ``estimate_stream_alignment``), epochs live on the BASE stream and the
    rover's observables are interpolated to each epoch's GPS instant;
    without it the two streams are differenced sample-for-sample (shared
    sample clock)."""
    avail = sorted(set(base.arcs) & set(rover.arcs))
    prns = [p for p in (prns or avail) if p in avail]
    if len(prns) < 4:
        raise ValueError(f"need >=4 common satellites, have {prns}")

    per: dict[int, dict[int, tuple]] = {}
    for p in prns:
        ab, ar = base.longest_arc(p), rover.longest_arc(p)
        if alignment is not None:
            per[p] = _sd_series_aligned(ab, ar, alignment)
            continue
        series = {}
        mb = {m: i for i, m in enumerate(ab.ms)}
        for i_r, m in enumerate(ar.ms):
            i_b = mb.get(m)
            if i_b is None or not (ab.locked[i_b] and ar.locked[i_r]):
                continue
            series[m] = (
                ar.phase_cycles[i_r] - ab.phase_cycles[i_b],  # SD phase (cycles)
                ar.code_delay_s[i_r] - ab.code_delay_s[i_b],  # SD code (s)
            )
        per[p] = series

    common = set.intersection(*(set(s) for s in per.values()))
    common = sorted(m for m in common if m >= settle_ms)
    common = common[::epoch_every_ms]
    if len(common) < 2:
        raise ValueError("fewer than 2 common locked epochs across satellites")

    if ref_prn is None:  # most epochs, then lowest PRN: deterministic
        ref_prn = max(prns, key=lambda p: (len(per[p]), -p))
    others = [p for p in prns if p != ref_prn]

    def sd_code_median(p: int, m: int) -> float:
        """Window-median of the single-difference code around epoch ``m``.

        A single 1 ms sub-sample code measurement at 2 samples/chip is
        ~10 m noisy; the SD code is constant over the window to mm (its
        rate is the between-receiver range-rate difference, mm/s for short
        baselines), so the median over the window divides the noise by
        ~sqrt(window) without smearing geometry."""
        half = epoch_every_ms // 2
        vals = np.array([
            per[p][k][1]
            for k in range(m - half, m + half + 1)
            if k in per[p]
        ])
        # Re-center onto the first value's 1 ms branch: a code-delay wrap
        # crossing inside the window would otherwise split the samples
        # across a 1 ms jump and corrupt the median.
        vals = vals[0] + _wrap_ms(vals - vals[0])
        return float(np.median(vals))

    t = np.array(common, np.float64) * 1e-3
    phase = np.empty((len(common), len(others)))
    code = np.empty_like(phase)
    for j, p in enumerate(others):
        for i, m in enumerate(common):
            sd_p, _ = per[p][m]
            sd_pr, _ = per[ref_prn][m]
            phase[i, j] = 2.0 * (sd_p - sd_pr)  # half-cycles
            code[i, j] = _wrap_ms(
                sd_code_median(p, m) - sd_code_median(ref_prn, m)
            ) * SPEED_OF_LIGHT
    return DDObservations(
        prns=others, ref_prn=ref_prn, epochs_s=t,
        phase_half_cycles=phase, code_m=code,
    )


# --------------------------------------------------------------------------
# Integer least squares (LAMBDA-style)
# --------------------------------------------------------------------------


def _ltdl(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Q = L.T @ diag(d) @ L with L unit lower triangular."""
    n = Q.shape[0]
    Qw = Q.astype(np.float64).copy()
    L = np.zeros((n, n))
    d = np.zeros(n)
    for k in range(n - 1, -1, -1):
        d[k] = Qw[k, k]
        if d[k] <= 0:
            raise np.linalg.LinAlgError("covariance not positive definite")
        L[k, : k + 1] = Qw[k, : k + 1] / d[k]
        Qw[:k, :k] -= d[k] * np.outer(L[k, :k], L[k, :k])
    return L, d


def _decorrelate(Q: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LAMBDA Z-reduction: returns (L, d, Z) with Z integer unimodular and
    Z.T @ Q @ Z = L.T @ diag(d) @ L well-conditioned for the search."""
    L, d = _ltdl(Q)
    n = len(d)
    Z = np.eye(n)
    k = n - 2
    while k >= 0:
        # Integer Gauss transform: make |L[k+1, k]| <= 1/2.
        mu = np.round(L[k + 1, k])
        if mu != 0:
            L[k + 1 :, k] -= mu * L[k + 1 :, k + 1]
            Z[:, k] -= mu * Z[:, k + 1]
        lam = L[k + 1, k]
        delta = d[k] + lam * lam * d[k + 1]
        if delta < d[k + 1] - 1e-14:
            # Symmetric permutation of k, k+1 (de Jonge & Tiberius '96, §3.6).
            eta = d[k] / delta
            lam_bar = d[k + 1] * lam / delta
            d[k] = eta * d[k + 1]
            d[k + 1] = delta
            block = np.array([[-lam, 1.0], [eta, lam_bar]])
            L[k : k + 2, :k] = block @ L[k : k + 2, :k]
            L[k + 1, k] = lam_bar
            L[k + 2 :, [k, k + 1]] = L[k + 2 :, [k + 1, k]]
            Z[:, [k, k + 1]] = Z[:, [k + 1, k]]
            k = min(k + 1, n - 2)
        else:
            # Reduce the rest of column k while we are here.
            for i in range(k + 2, n):
                mu = np.round(L[i, k])
                if mu != 0:
                    L[i:, k] -= mu * L[i:, i]
                    Z[:, k] -= mu * Z[:, i]
            k -= 1
    return L, d, Z


def _ils_search(
    a: np.ndarray, L: np.ndarray, d: np.ndarray, n_cand: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Exact integer-least-squares search for the ``n_cand`` best vectors.

    Minimizes (a - z)^T Q^{-1} (a - z) with Q = L^T diag(d) L: writing
    w = L^{-T} (a - z), the cost is sum w_k^2 / d_k with
    w_k = (a_k - sum_{j>k} L[j, k] w_j) - z_k, searched depth-first from
    k = n-1 with branch-and-bound pruning.

    Returns (candidates [n_cand, n], costs [n_cand]).
    """
    n = len(a)
    best: list[tuple[float, np.ndarray]] = []
    z = np.zeros(n)
    w = np.zeros(n)

    def cond(k: int) -> float:
        return a[k] - sum(L[j, k] * w[j] for j in range(k + 1, n))

    def recurse(k: int, cost: float) -> None:
        if len(best) == n_cand and cost >= best[-1][0]:
            return
        if k < 0:
            best.append((cost, z.copy()))
            best.sort(key=lambda t: t[0])
            del best[n_cand:]
            return
        ak = cond(k)
        z0 = np.round(ak)
        step = 1.0 if ak - z0 > 0 else -1.0  # next-closest integer first
        # Enumerate z_k by increasing |ak - z_k|: z0, z0+s, z0-s, z0+2s, ...
        i = 0
        while True:
            if i == 0:
                zk = z0
            elif i % 2 == 1:
                zk = z0 + step * ((i + 1) // 2)
            else:
                zk = z0 - step * (i // 2)
            dc = (ak - zk) ** 2 / d[k]
            if len(best) == n_cand and cost + dc >= best[-1][0]:
                if i == 0:
                    return
                break
            z[k] = zk
            w[k] = ak - zk
            recurse(k - 1, cost + dc)
            i += 1
            if i > 1000:  # pathological covariance; bail with what we have
                break

    recurse(n - 1, 0.0)
    if not best:
        raise RuntimeError("integer search found no candidate")
    cands = np.stack([b[1] for b in best])
    costs = np.array([b[0] for b in best])
    return cands, costs


def bootstrap_success_rate(Q: np.ndarray) -> float:
    """Teunissen's integer-bootstrapping success probability from the
    decorrelated conditional variances: P = prod_k (2 Phi(1/(2 sigma_k)) - 1)
    with sigma_k = sqrt(d_k) of the Z-reduced LtDL. A lower bound on the ILS
    success rate — the model-driven companion to the (data-driven) ratio
    test: an ambiguity covariance too wide to support fixing is rejected even
    when the observed ratio happens to look good."""
    from math import erf, sqrt

    _, d, _ = _decorrelate(Q)
    p = 1.0
    for dk in d:
        x = 0.5 / np.sqrt(dk)
        p *= erf(x / sqrt(2.0))  # 2 Phi(x) - 1
    return float(p)


def integer_least_squares(
    a_float: np.ndarray, Q: np.ndarray, n_cand: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Best ``n_cand`` integer vectors for ambiguity float solution
    ``a_float`` with covariance ``Q``, costs in the Q^{-1} metric."""
    L, d, Z = _decorrelate(Q)
    a_dec = Z.T @ a_float
    cands_dec, costs = _ils_search(a_dec, L, d, n_cand=n_cand)
    # a_dec = Z^T a, so candidates map back by z = Z^{-T} z_dec (Z is
    # unimodular: the solve is exactly integer up to f64 rounding).
    cands = np.stack([np.round(np.linalg.solve(Z.T, c)) for c in cands_dec])
    return cands, costs


# --------------------------------------------------------------------------
# Baseline solution
# --------------------------------------------------------------------------


@dataclass
class RtkSolution:
    baseline_float_m: np.ndarray  # ECEF rover - base, float ambiguities
    baseline_fixed_m: np.ndarray | None  # with integer ambiguities (or None)
    ambiguities: np.ndarray | None  # half-cycle integers, per dd.prns
    ratio: float  # ILS second-best / best cost (>=1; big = confident)
    fixed: bool
    n_epochs: int
    prns: list[int]
    ref_prn: int
    sigma_float_m: np.ndarray  # formal 1-sigma of the float baseline (3,)
    phase_rms_half_cycles: float  # fixed-solution phase residual RMS
    bootstrap_success: float = 1.0  # model-driven fix-success lower bound


def _dd_rho(x_rover, base_ecef, sv_s, sv_r):
    """DD geometric range for satellite positions sv_s/sv_r [T,3]."""
    rb_s = np.linalg.norm(sv_s - base_ecef, axis=-1)
    rb_r = np.linalg.norm(sv_r - base_ecef, axis=-1)
    rv_s = np.linalg.norm(sv_s - x_rover, axis=-1)
    rv_r = np.linalg.norm(sv_r - x_rover, axis=-1)
    return (rv_s - rb_s) - (rv_r - rb_r)


def solve_baseline(
    dd: DDObservations,
    sv_pos_fn,
    base_ecef: np.ndarray,
    sigma_phase_half_cycles: float = 0.02,
    sigma_code_m: float = 1.0,
    ratio_threshold: float = 2.0,
    min_bootstrap_success: float = 0.99,
    fix: bool = True,
) -> RtkSolution:
    """Float + integer-fixed baseline from double differences.

    ``sv_pos_fn(prn, t_stream_s) -> ECEF [3]`` supplies satellite positions
    (decoded ephemeris or scenario truth). Transit-time/Sagnac refinements are
    omitted: their direction errors are common to both receivers and scale
    into DD only by baseline/range (~1e-6), sub-mm for km-scale baselines.
    """
    base_ecef = np.asarray(base_ecef, np.float64)
    T, m1 = dd.phase_half_cycles.shape
    sv = np.stack(
        [[sv_pos_fn(p, t) for p in dd.prns + [dd.ref_prn]] for t in dd.epochs_s]
    )  # [T, m, 3]
    sv_s, sv_r = sv[:, :-1, :], sv[:, -1:, :]  # [T, m-1, 3], [T, 1, 3]

    w_p = 1.0 / sigma_phase_half_cycles
    w_c = 1.0 / sigma_code_m
    scale = 2.0 * GPS_L1_FREQUENCY_HZ / SPEED_OF_LIGHT  # m -> half-cycles

    def jacobian(x):
        """d(DD_rho)/dx at rover position x: [T, m-1, 3]."""
        e_s = sv_s - x
        e_s /= np.linalg.norm(e_s, axis=-1, keepdims=True)
        e_r = sv_r - x
        e_r /= np.linalg.norm(e_r, axis=-1, keepdims=True)
        return -(e_s - e_r)  # [T, m-1, 3]

    # ---- float solution: Gauss-Newton on [dx(3), a(m-1)] ----
    x = base_ecef.copy()
    a = np.zeros(m1)
    for _ in range(4):
        rho = _dd_rho(x[None, None, :], base_ecef, sv_s, sv_r[:, 0:1, :])  # [T, m-1]
        H = jacobian(x)  # [T, m-1, 3]
        r_phase = dd.phase_half_cycles - (-scale * rho + a)  # [T, m-1]
        r_code = dd.code_m - rho
        # Weighted rows: phase (T*m1 rows: d/dx = -scale*H, d/da_j = 1 on
        # its own DD column) then code (T*m1 rows: d/dx = H, no a).
        A_phase = np.zeros((T, m1, 3 + m1))
        A_phase[:, :, :3] = -scale * H * w_p
        for j in range(m1):
            A_phase[:, j, 3 + j] = w_p
        A_code = np.zeros((T, m1, 3 + m1))
        A_code[:, :, :3] = H * w_c
        A = np.concatenate(
            [A_phase.reshape(T * m1, -1), A_code.reshape(T * m1, -1)]
        )
        b = np.concatenate(
            [r_phase.reshape(-1) * w_p, r_code.reshape(-1) * w_c]
        )
        du, *_ = np.linalg.lstsq(A, b, rcond=None)
        x = x + du[:3]
        a = a + du[3:]
        if np.linalg.norm(du[:3]) < 1e-6:
            break

    N = A.T @ A
    cov = np.linalg.inv(N)
    Q_a = cov[3:, 3:]
    sigma_float = np.sqrt(np.diag(cov[:3, :3]))
    baseline_float = x - base_ecef

    fixed = False
    ratio = 0.0
    p_boot = 1.0
    baseline_fixed = None
    a_int = None
    phase_rms = float("nan")
    if fix:
        cands, costs = integer_least_squares(a, Q_a, n_cand=2)
        ratio = float(costs[1] / max(costs[0], 1e-12)) if len(costs) > 1 else np.inf
        p_boot = bootstrap_success_rate(Q_a)
        a_int = cands[0].astype(np.int64)
        # ---- fixed solution: phase-only Gauss-Newton, a held integer ----
        xf = x.copy()
        for _ in range(4):
            rho = _dd_rho(xf[None, None, :], base_ecef, sv_s, sv_r[:, 0:1, :])
            H = jacobian(xf)
            r_phase = dd.phase_half_cycles - (-scale * rho + a_int)
            Af = -scale * H.reshape(T * m1, 3)
            bf = r_phase.reshape(-1)
            du, *_ = np.linalg.lstsq(Af, bf, rcond=None)
            xf = xf + du
            if np.linalg.norm(du) < 1e-8:
                break
        resid = dd.phase_half_cycles - (
            -scale * _dd_rho(xf[None, None, :], base_ecef, sv_s, sv_r[:, 0:1, :])
            + a_int
        )
        phase_rms = float(np.sqrt(np.mean(resid**2)))
        baseline_fixed = xf - base_ecef
        # Both validation gates must agree: the data-driven ratio AND the
        # model-driven bootstrap success bound. The Monte-Carlo study
        # (tools/rtk_study.py) shows wrong fixes slipping through the ratio
        # test alone at ratios up to ~3; their covariances flunk this bound.
        fixed = ratio >= ratio_threshold and p_boot >= min_bootstrap_success
        if not fixed:
            _logger.info(
                "RTK not fixed: ratio %.2f (need %.2f), bootstrap success "
                "%.4f (need %.3f) — reporting float", ratio, ratio_threshold,
                p_boot, min_bootstrap_success,
            )

    return RtkSolution(
        baseline_float_m=baseline_float,
        baseline_fixed_m=baseline_fixed,
        ambiguities=a_int,
        ratio=ratio,
        fixed=fixed,
        n_epochs=T,
        prns=list(dd.prns),
        ref_prn=dd.ref_prn,
        sigma_float_m=sigma_float,
        phase_rms_half_cycles=phase_rms,
        bootstrap_success=p_boot,
    )


@dataclass
class KinematicSolution:
    epochs_s: np.ndarray  # [T]
    baselines_float_m: np.ndarray  # [T, 3] per-epoch rover - base
    baselines_fixed_m: np.ndarray | None  # [T, 3]
    ambiguities: np.ndarray | None
    ratio: float
    fixed: bool
    prns: list[int]
    ref_prn: int


def _kinematic_float(
    dd: DDObservations,
    sv_pos_fn,
    base_ecef: np.ndarray,
    sigma_phase_half_cycles: float,
    sigma_code_m: float,
):
    """Gauss-Newton float solve of the kinematic model: one rover position
    per epoch (3T unknowns) + m-1 shared DD ambiguities.

    Returns ``(X [T,3], a [m-1], Q_a [m-1,m-1], per_epoch_geometry)`` where
    ``per_epoch_geometry(X) -> (rho [T,m-1], H [T,m-1,3])`` evaluates the DD
    geometric ranges and their position Jacobians at per-epoch positions.
    Shared by ``solve_kinematic`` and the attitude solver (solve/attitude.py),
    which re-scores multiple integer candidates against a known baseline
    length and so needs the float pieces individually."""
    T, m1 = dd.phase_half_cycles.shape
    sv = np.stack(
        [[sv_pos_fn(p, t) for p in dd.prns + [dd.ref_prn]] for t in dd.epochs_s]
    )
    sv_s, sv_r = sv[:, :-1, :], sv[:, -1:, :]

    w_p = 1.0 / sigma_phase_half_cycles
    w_c = 1.0 / sigma_code_m
    scale = 2.0 * GPS_L1_FREQUENCY_HZ / SPEED_OF_LIGHT

    def per_epoch_geometry(X):
        """rho [T, m-1] and d(rho)/dx [T, m-1, 3] at per-epoch positions X."""
        rho = np.empty((T, m1))
        H = np.empty((T, m1, 3))
        for t in range(T):
            rho[t] = _dd_rho(X[t][None, None, :], base_ecef,
                             sv_s[t : t + 1], sv_r[t : t + 1, 0:1, :])[0]
            e_s = sv_s[t] - X[t]
            e_s /= np.linalg.norm(e_s, axis=-1, keepdims=True)
            e_r = sv_r[t, 0] - X[t]
            e_r /= np.linalg.norm(e_r)
            H[t] = -(e_s - e_r)
        return rho, H

    # ---- float: [x_1..x_T (3T), a (m-1)] Gauss-Newton ----
    X = np.tile(base_ecef, (T, 1))
    a = np.zeros(m1)
    n_unk = 3 * T + m1
    for _ in range(4):
        rho, H = per_epoch_geometry(X)
        r_phase = dd.phase_half_cycles - (-scale * rho + a)
        r_code = dd.code_m - rho
        A = np.zeros((2 * T * m1, n_unk))
        b = np.empty(2 * T * m1)
        for t in range(T):
            rp = slice(t * m1, (t + 1) * m1)  # phase rows of epoch t
            rc = slice(T * m1 + t * m1, T * m1 + (t + 1) * m1)
            xs = slice(3 * t, 3 * t + 3)
            A[rp, xs] = -scale * H[t] * w_p
            A[rp, 3 * T :] = np.eye(m1) * w_p
            A[rc, xs] = H[t] * w_c
            b[rp] = r_phase[t] * w_p
            b[rc] = r_code[t] * w_c
        du, *_ = np.linalg.lstsq(A, b, rcond=None)
        X = X + du[: 3 * T].reshape(T, 3)
        a = a + du[3 * T :]
        if np.linalg.norm(du[: 3 * T]) / max(T, 1) < 1e-6:
            break

    cov = np.linalg.inv(A.T @ A)
    Q_a = cov[3 * T :, 3 * T :]
    return X, a, Q_a, per_epoch_geometry


def _fixed_epoch_positions(
    dd: DDObservations,
    per_epoch_geometry,
    X0: np.ndarray,
    a_int: np.ndarray,
    sigma_phase_half_cycles: float,
    sigma_code_m: float,
) -> np.ndarray:
    """Per-epoch rover positions with the ambiguities held at ``a_int``:
    each epoch's phase rows (+ weak code rows) alone pin its position."""
    w_p = 1.0 / sigma_phase_half_cycles
    w_c = 1.0 / sigma_code_m
    scale = 2.0 * GPS_L1_FREQUENCY_HZ / SPEED_OF_LIGHT
    T = X0.shape[0]
    Xf = X0.copy()
    for _ in range(3):
        rho, H = per_epoch_geometry(Xf)
        r_phase = dd.phase_half_cycles - (-scale * rho + a_int)
        r_code = dd.code_m - rho
        for t in range(T):
            At = np.concatenate([-scale * H[t] * w_p, H[t] * w_c])
            bt = np.concatenate([r_phase[t] * w_p, r_code[t] * w_c])
            du, *_ = np.linalg.lstsq(At, bt, rcond=None)
            Xf[t] = Xf[t] + du
    return Xf


def solve_kinematic(
    dd: DDObservations,
    sv_pos_fn,
    base_ecef: np.ndarray,
    sigma_phase_half_cycles: float = 0.02,
    sigma_code_m: float = 1.0,
    ratio_threshold: float = 2.0,
    min_bootstrap_success: float = 0.99,
) -> KinematicSolution:
    """Per-epoch baselines for a MOVING rover, single shared ambiguity set.

    The float model estimates one rover position per epoch (3T unknowns)
    plus the m-1 shared ambiguities; with the integers fixed, each epoch's
    phase rows alone pin its baseline to centimeters — the carrier-phase
    trajectory of the rover. Static scenes should prefer ``solve_baseline``
    (one position, T-fold averaging)."""
    base_ecef = np.asarray(base_ecef, np.float64)
    X, a, Q_a, per_epoch_geometry = _kinematic_float(dd, sv_pos_fn, base_ecef,
                                                     sigma_phase_half_cycles,
                                                     sigma_code_m)
    baselines_float = X - base_ecef

    cands, costs = integer_least_squares(a, Q_a, n_cand=2)
    ratio = float(costs[1] / max(costs[0], 1e-12)) if len(costs) > 1 else np.inf
    a_int = cands[0].astype(np.int64)
    # Same dual gate as solve_baseline: ratio (data) + bootstrap (model).
    # Note the formal Q_a is only as honest as the sigma arguments — feed
    # the MEASURED phase noise (e.g. solve_baseline's phase RMS from a
    # static initialization window) rather than a conservative default, or
    # the bound under-reports what the data supports.
    fixed = (ratio >= ratio_threshold
             and bootstrap_success_rate(Q_a) >= min_bootstrap_success)

    Xf = _fixed_epoch_positions(dd, per_epoch_geometry, X, a_int,
                                sigma_phase_half_cycles, sigma_code_m)

    return KinematicSolution(
        epochs_s=dd.epochs_s,
        baselines_float_m=baselines_float,
        baselines_fixed_m=Xf - base_ecef,
        ambiguities=a_int,
        ratio=ratio,
        fixed=fixed,
        prns=list(dd.prns),
        ref_prn=dd.ref_prn,
    )


def dd_from_rinex(
    base_obs_text: str,
    rover_obs_text: str,
    prns: list[int] | None = None,
    ref_prn: int | None = None,
) -> DDObservations:
    """Double differences from two RINEX 3.04 observation files.

    The RTK engine as an interoperability surface: any receiver pair that
    logs C1C + L1C (this framework's ``replay --rinex-obs``, RTKLIB-class
    tools, survey receivers) can be solved with ``solve_baseline`` /
    ``solve_kinematic``. Pseudoranges are full-range, so no millisecond
    wrapping is needed; carrier arcs split at the loss-of-lock flag and the
    longest arc per satellite is used. Epochs are GPS seconds of week —
    pair with an ``sv_pos_fn`` on the same scale
    (``sv_position_fn_from_ephemerides(eph, 0.0)`` with RINEX-NAV
    ephemerides, whose t_oe is already SOW).
    """
    from gypsum_tpu_torch.obs.rinex import GPS_EPOCH, parse_obs

    base_p = parse_obs(base_obs_text)
    rover_p = parse_obs(rover_obs_text)

    def series(parsed):
        """prn -> {sow: (phase_L1C, code_m)} for that PRN's longest arc."""
        per: dict[int, list[dict]] = {}
        for when, rows in parsed.epochs:
            sow = (when - GPS_EPOCH).total_seconds() % (7 * 86400.0)
            for prn, vals in rows.items():
                if "C1C" not in vals or "L1C" not in vals:
                    continue
                arcs = per.setdefault(prn, [{}])
                if vals.get("L1C_slip") and arcs[-1]:
                    arcs.append({})
                arcs[-1][sow] = (vals["L1C"], vals["C1C"])
        return {p: max(arcs, key=len) for p, arcs in per.items() if any(arcs)}

    sb, sr = series(base_p), series(rover_p)
    avail = sorted(set(sb) & set(sr))
    prns = [p for p in (prns or avail) if p in avail]
    if len(prns) < 4:
        raise ValueError(f"need >=4 common satellites, have {prns}")
    common = sorted(set.intersection(
        *(set(sb[p]) & set(sr[p]) for p in prns)
    ))
    if len(common) < 2:
        raise ValueError("fewer than 2 common epochs")
    if ref_prn is None:
        ref_prn = max(prns, key=lambda p: (len(sb[p]), -p))
    others = [p for p in prns if p != ref_prn]

    t = np.array(common)
    phase = np.empty((len(common), len(others)))
    code = np.empty_like(phase)
    for j, p in enumerate(others):
        for i, sow in enumerate(common):
            sd_l = sr[p][sow][0] - sb[p][sow][0]
            sd_lr = sr[ref_prn][sow][0] - sb[ref_prn][sow][0]
            # RINEX L1C grows with range (minus the NCO's cycles):
            # DD_phi (half-cycles, NCO sign) = -2 * DD(L1C).
            phase[i, j] = -2.0 * (sd_l - sd_lr)
            code[i, j] = (sr[p][sow][1] - sb[p][sow][1]) - (
                sr[ref_prn][sow][1] - sb[ref_prn][sow][1]
            )
    return DDObservations(
        prns=others, ref_prn=ref_prn, epochs_s=t,
        phase_half_cycles=phase, code_m=code,
    )


@dataclass
class TimeTransferResult:
    """Common-view time transfer between two receivers at KNOWN positions."""

    epochs_s: np.ndarray  # [T]
    offset_s: np.ndarray  # [T] per-epoch clock(rover) - clock(base), code-based
    offset_at_start_s: float  # linear-fit intercept at epochs_s[0]
    drift_s_per_s: float  # linear-fit slope of the code offsets
    drift_carrier_s_per_s: float  # from the common carrier drift (far tighter)
    sigma_offset_s: float  # RMS of per-epoch offsets about the fit
    prns: list[int]


def time_transfer(
    base: CarrierPhaseLog,
    rover: CarrierPhaseLog,
    base_ecef: np.ndarray,
    rover_ecef: np.ndarray,
    sv_pos_fn,
    prns: list[int] | None = None,
    epoch_every_ms: int = 250,
    settle_ms: int = 2000,
) -> TimeTransferResult:
    """Common-view GNSS time transfer: the inter-receiver clock offset.

    Both positions are known; for each common satellite the single-difference
    code delay minus the predicted geometric difference leaves
    ``clock(rover) - clock(base)`` plus noise, which the cross-satellite
    median and a linear fit over epochs reduce to nanoseconds. The common
    carrier drift (every satellite's SD phase slides at ``-f_L1 * d``)
    measures the relative oscillator drift orders of magnitude tighter than
    the code fit.

    The code observable wraps at 1 ms: offsets must be < 0.5 ms (captures
    nominally synchronized, e.g. both started on a PPS).
    """
    base_ecef = np.asarray(base_ecef, np.float64)
    rover_ecef = np.asarray(rover_ecef, np.float64)
    avail = sorted(set(base.arcs) & set(rover.arcs))
    prns = [p for p in (prns or avail) if p in avail]
    if not prns:
        raise ValueError("no common satellites")

    per: dict[int, dict[int, tuple]] = {}
    for p in prns:
        ab, ar = base.longest_arc(p), rover.longest_arc(p)
        mb = {m: i for i, m in enumerate(ab.ms)}
        series = {}
        for i_r, m in enumerate(ar.ms):
            i_b = mb.get(m)
            if i_b is None or not (ab.locked[i_b] and ar.locked[i_r]):
                continue
            series[m] = (
                ar.phase_cycles[i_r] - ab.phase_cycles[i_b],
                ar.code_delay_s[i_r] - ab.code_delay_s[i_b],
            )
        if series:
            per[p] = series
    prns = sorted(per)
    common = set.intersection(*(set(s) for s in per.values()))
    common = sorted(m for m in common if m >= settle_ms)[::epoch_every_ms]
    if len(common) < 3:
        raise ValueError("fewer than 3 common locked epochs")

    half = epoch_every_ms // 2
    epochs = np.array(common, np.float64) * 1e-3
    offsets = np.empty((len(common), len(prns)))
    phase_sd = np.empty_like(offsets)
    for j, p in enumerate(prns):
        for i, m in enumerate(common):
            vals = np.array([
                per[p][k][1] for k in range(m - half, m + half + 1) if k in per[p]
            ])
            vals = vals[0] + _wrap_ms(vals - vals[0])
            sd_code = float(np.median(vals))
            t = epochs[i]
            geom = (
                np.linalg.norm(sv_pos_fn(p, t) - rover_ecef)
                - np.linalg.norm(sv_pos_fn(p, t) - base_ecef)
            ) / SPEED_OF_LIGHT
            # Measured SD delay = geometry difference + (clock_v - clock_b):
            # a slow rover clock timestamps the same code edge later.
            offsets[i, j] = _wrap_ms(np.array([sd_code - geom]))[0]
            phase_sd[i, j] = per[p][m][0]

    off = np.median(offsets, axis=1)  # [T]
    slope, intercept = np.polyfit(epochs - epochs[0], off, 1)
    resid = off - (intercept + slope * (epochs - epochs[0]))

    # Carrier: SD phase drifts at -f_L1 * d for EVERY satellite (the LO term
    # is common); the cross-satellite median of the per-SV linear slopes
    # rejects the (tiny, geometry-driven) per-SV terms.
    ph_slopes = np.polyfit(epochs - epochs[0], phase_sd, 1)[0]  # [P] cycles/s
    drift_carrier = float(-np.median(ph_slopes) / GPS_L1_FREQUENCY_HZ)

    return TimeTransferResult(
        epochs_s=epochs,
        offset_s=off,
        offset_at_start_s=float(intercept),
        drift_s_per_s=float(slope),
        drift_carrier_s_per_s=drift_carrier,
        sigma_offset_s=float(np.std(resid)),
        prns=prns,
    )


def sv_position_fn_from_ephemerides(ephemerides: dict[int, "object"],
                                    stream_to_sow: float):
    """Adapter: ``sv_pos_fn`` from per-PRN broadcast ephemerides.

    ``stream_to_sow``: seconds to add to stream time to get GPS seconds of
    week (the scenario's start SOW, or the world model's clock slide)."""
    from gypsum_tpu_torch.solve.ephemeris import satellite_position

    nominal_transit = 0.072

    def fn(prn: int, t_stream: float) -> np.ndarray:
        return satellite_position(
            ephemerides[prn], t_stream + stream_to_sow - nominal_transit
        )

    return fn
