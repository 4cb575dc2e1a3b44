"""WorldModel mixin: pseudorange assembly and measurement conditioning.

Split from solve/world.py (round-4 verdict item 7). Everything that turns
channel observables into a weighted measurement set: the Hatch
carrier-smoothing filter, the per-fix (satellite position, transit time)
assembly with atmospheric/SBAS corrections, the C/N0- and URA-scaled
per-satellite sigmas, and the Doppler/TDCP velocity solve.

reference: gypsum/world_model.py:567-633 (measurement assembly inside the
fix; smoothing/weighting/velocity have no analogue).
"""

from __future__ import annotations

import logging

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GPS_L1_FREQUENCY_HZ,
    SPEED_OF_LIGHT_M_PER_S as C,
)
from gypsum_tpu_torch.solve.geodesy import ecef_to_lla
from gypsum_tpu_torch.solve.world_records import _SatelliteRecord

_logger = logging.getLogger(__name__)


class MeasurementMixin:
    """Measurement assembly + conditioning for WorldModel."""

    def _update_carrier_smoothing(
        self, rec: _SatelliteRecord, measured_s: float, count: int, doppler_hz: float | None
    ) -> None:
        """Hatch filter: blend the (noisy) code measurement with the
        carrier-propagated previous smoothed delay. The carrier predicts the
        delay's evolution as d(delay)/dt = -doppler / f_L1 (the same relation
        carrier aiding uses in the tracker) with mm-per-second noise, so a
        window-N blend shrinks code noise ~ sqrt(N)."""
        n_max = max(1, self.config.carrier_smoothing_window)
        if doppler_hz is None or rec.smoothed_delay_s is None:
            rec.smoothed_delay_s = measured_s
            rec.smoothing_depth = 1
            return
        dt = count * 1e-3
        f_car = rec.carrier_hz or GPS_L1_FREQUENCY_HZ
        predicted = rec.smoothed_delay_s - (doppler_hz / f_car) * dt
        # The raw measurement lives mod 1 ms but the maintained delay is
        # CONTINUOUS (it may walk past +/-0.5 ms — its millisecond is pinned
        # to the tick anchor, handle_subframe_emitted). Wrapping the
        # innovation to [-0.5, 0.5) ms folds the measurement onto the
        # continuous track; a genuine cycle slip shows up as a large wrapped
        # innovation and resets (the next subframe re-anchors the ms).
        innovation = ((measured_s - predicted + 0.5e-3) % 1e-3) - 0.5e-3
        if abs(innovation) > 0.25e-3:
            rec.smoothed_delay_s = measured_s
            rec.smoothing_depth = 1
            return
        depth = min(rec.smoothing_depth + 1, n_max)
        rec.smoothed_delay_s = predicted + innovation / depth
        rec.smoothing_depth = depth

    def _measurement_set(
        self, receiver_timestamp: float, prns: list[int], pos_est: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Satellite positions [N, 3] and corrected pseudo transit times [N]
        for ``prns`` at the receiver's current stream position, using
        ``pos_est`` for the atmospheric-correction geometry (a zero /
        non-terrestrial estimate skips the corrections — a cold receiver has
        no geometry to correct with). Shared by the least-squares rounds and
        the EKF's measurement construction."""
        cfg = self.config
        sat_pos = np.empty((len(prns), 3))
        transit = np.empty(len(prns))
        # Per-solve observability of the dual-frequency measured iono
        # (consumed by the solution constructors; last round wins).
        self._iono_measured_m = {}
        # Atmospheric-correction geometry shared by every row this round
        # (ecef_to_lla per SV per round was ~15% of the fix cost).
        correct_atmo = np.linalg.norm(pos_est) > 6.0e6 and (
            cfg.apply_tropo_correction
            or (cfg.apply_iono_correction and self.iono_utc is not None)
        )
        if correct_atmo:
            lat_u, lon_u, alt_u = ecef_to_lla(pos_est)
        # Cross-constellation measured iono (solve/world_multiconstellation
        # .py): only when no broadcast model exists — the model, once
        # decoded, is a per-pierce-point fit and takes precedence.
        iono_vertical_m = None
        if (
            correct_atmo
            and cfg.apply_iono_correction
            and cfg.cross_constellation_iono
            and self.iono_utc is None
        ):
            iono_vertical_m = self.iono_vertical_gps_l1_m(
                receiver_timestamp, pos_est
            )
        for i, prn in enumerate(prns):
            rec = self._sats[prn]
            sv_tow = self.observed_sv_time_of_week(prn)
            # Pseudo transit time = receiver's GPS-frame arrival time of
            # the current PRN edge minus the SV's emitted time (reference:
            # gypsum/world_model.py:362-377). Unlike the reference, the
            # per-SV sub-millisecond code-phase delay is included — in the
            # reference's formulation it cancels out of the tick/slide
            # arithmetic, quantizing inter-satellite pseudorange
            # differences to whole milliseconds (~300 km of range).
            #
            # The delay is wrapped to [-0.5, +0.5) ms: a chunk whose code
            # phase exceeds half a millisecond is dominated by the PRN
            # that *started in the previous chunk*, and the tick counter
            # (anchored by the bit integrator's chunk-aligned timestamps)
            # numbers PRN edges under exactly that convention — using the
            # raw delay would bias those satellites' pseudoranges by a
            # full code period (~300 km).
            if rec.smoothed_delay_s is not None:
                # Continuous since the tick anchor: NO re-wrapping (a
                # drift across +/-0.5 ms since the anchor is real range
                # motion, not a different millisecond).
                delay = rec.smoothed_delay_s
            else:
                delay = ((rec.code_phase_delay_s + 0.5e-3) % 1e-3) - 0.5e-3
            arrival = receiver_timestamp + delay
            transit[i] = (self.receiver_clock_slide + arrival) - sv_tow
            # GLONASS rows: remove the current inter-system bias estimate
            # (refined by each dual-constellation solve) so single-bias
            # consumers see GPS-frame-consistent pseudoranges.
            if rec.glonass is not None:
                transit[i] -= self.glonass_bias_s
            sat_pos[i] = rec.sv_position(
                sv_tow, kepler_iterations=cfg.kepler_iterations
            )
            # Dual-frequency MEASURED iono (GLONASS L1OF+L2OF, solve/
            # world_multiconstellation.py): needs no position geometry, so
            # it applies from the very first solve round — and supersedes
            # the Klobuchar model for this satellite below.
            # Gated on BOTH cfg.dual_frequency_iono (inside
            # measured_iono_l1_s) and the master apply_iono_correction
            # switch, so disabling the documented master switch reproduces
            # fully uncorrected behavior for GLONASS dual-frequency rows
            # too.
            iono_meas_s = (
                self.measured_iono_l1_s(prn, delay, receiver_timestamp)
                if rec.glonass is not None and cfg.apply_iono_correction
                else None
            )
            if iono_meas_s is not None:
                transit[i] -= iono_meas_s
                self._iono_measured_m[prn] = iono_meas_s * C
            # Atmospheric corrections: both make the code arrive LATE,
            # so subtract from the transit. They need a position
            # estimate for the geometry — rounds after the first have
            # one (round 0 runs uncorrected, like a cold reference
            # receiver).
            # - Klobuchar ionosphere (solve/iono.py), once subframe 4
            #   page 18 has been decoded;
            # - Saastamoinen troposphere (solve/tropo.py), model-only.
            if correct_atmo:
                from gypsum_tpu_torch.solve.geodesy import elevation_azimuth

                el, az = elevation_azimuth(pos_est, sat_pos[i])
                if (
                    cfg.apply_iono_correction
                    and self.iono_utc is not None
                    and iono_meas_s is None
                ):
                    from gypsum_tpu_torch.solve.iono import klobuchar_delay_s

                    # Klobuchar is referenced to GPS L1; the dispersive
                    # delay scales as f^-2 for a GLONASS carrier.
                    iono_f_scale = 1.0
                    if rec.glonass is not None:
                        iono_f_scale = (
                            GPS_L1_FREQUENCY_HZ / rec.glonass.carrier_frequency_hz
                        ) ** 2
                    transit[i] -= iono_f_scale * klobuchar_delay_s(
                        self.iono_utc, lat_u, lon_u, el, az,
                        self.receiver_clock_slide + receiver_timestamp,
                    )
                elif iono_vertical_m is not None and iono_meas_s is None:
                    # Mapped from the GLONASS dual-frequency vertical
                    # estimate, re-slanted by this row's own obliquity and
                    # scaled to its carrier.
                    from gypsum_tpu_torch.solve.iono import klobuchar_obliquity

                    f_row = (
                        rec.glonass.carrier_frequency_hz
                        if rec.glonass is not None
                        else GPS_L1_FREQUENCY_HZ
                    )
                    mapped_s = (
                        iono_vertical_m
                        * klobuchar_obliquity(el)
                        * (GPS_L1_FREQUENCY_HZ / f_row) ** 2
                        / C
                    )
                    transit[i] -= mapped_s
                    self._iono_measured_m[prn] = mapped_s * C
                if cfg.apply_tropo_correction:
                    from gypsum_tpu_torch.solve.tropo import tropo_delay_s

                    transit[i] -= tropo_delay_s(el, alt_u)
            # SBAS fast correction (solve/sbas_corrections.py):
            # PR_corrected = PR_measured + PRC, i.e. + PRC/c on the transit.
            if cfg.apply_sbas_corrections:
                corr = self.sbas_corrections.correction_for(
                    prn, receiver_timestamp
                )
                if corr is not None:
                    transit[i] += corr.prc_m / C
        return sat_pos, transit

    def _sigma_for(self, prn: int, now: float | None = None) -> float:
        """Per-satellite 1-sigma pseudorange error for integrity weighting:
        the configured sigma scaled by the channel's measured C/N0
        (obs/cn0.py; unmeasured channels keep the nominal), RSS'd with the
        broadcast URA for SBAS GEOs (orbit error is independent of thermal
        noise)."""
        rec = self._sats[prn]
        base = self.config.pseudorange_sigma_m
        if rec.cn0_dbhz is not None:
            from gypsum_tpu_torch.obs.cn0 import sigma_from_cn0

            base = sigma_from_cn0(rec.cn0_dbhz, self.config.pseudorange_sigma_m)
        if rec.geo is not None and rec.ephemeris is None:
            from gypsum_tpu_torch.solve.integrity import ura_index_to_sigma_m

            ura = ura_index_to_sigma_m(rec.geo.ura)
            return float(np.sqrt(base * base + ura * ura))
        if self.config.apply_sbas_corrections and now is not None:
            corr = self.sbas_corrections.correction_for(prn, now)
            if corr is not None:
                # Corrected satellite: the broadcast UDREI bounds what the
                # PRC leaves behind (DO-229 Table A-6 variance).
                return float(np.sqrt(base * base + corr.sigma2_udre_m2))
        return float(base)
    def _solve_velocity(
        self, prns: list[int], rx_ecef: np.ndarray, sat_pos_all: np.ndarray
    ):
        """Velocity + clock drift (solve/velocity.py); the reference has no
        analogue. Preferred path: TDCP — the NCO's own cycle count over the
        block integrates the Doppler with millicycle noise, giving mm/s-class
        velocity; channels without a continuous locked block (or with the
        knob off) fall back to the instantaneous-Doppler solve. Satellite
        positions are reused from the position solve's final round."""
        from gypsum_tpu_torch.solve.velocity import solve_tdcp, solve_velocity

        cfg = self.config
        if cfg.tdcp_velocity:
            usable = [
                i for i, p in enumerate(prns)
                if self._sats[p].tdcp_cycles is not None
                and self._sats[p].tdcp_dt_s > 0
            ]
            if len(usable) >= 4:
                dts = {self._sats[prns[i]].tdcp_dt_s for i in usable}
                if len(dts) == 1:  # one shared block interval
                    dt = dts.pop()
                    pos_t1 = sat_pos_all[usable]
                    pos_t0 = np.empty_like(pos_t1)
                    dclk = np.empty(len(usable))
                    dphi = np.empty(len(usable))
                    for j, i in enumerate(usable):
                        rec = self._sats[prns[i]]
                        sv_tow = self.observed_sv_time_of_week(prns[i])
                        pos_t0[j] = rec.sv_position(
                            sv_tow - dt, kepler_iterations=cfg.kepler_iterations
                        )
                        dclk[j] = rec.sv_clock_correction(
                            sv_tow, iterations=4
                        ) - rec.sv_clock_correction(sv_tow - dt, iterations=4)
                        dphi[j] = rec.tdcp_cycles
                    v, drift = solve_tdcp(
                        pos_t0, pos_t1, dclk, rx_ecef, dphi, dt,
                        wavelengths_m=self._wavelengths_for([prns[i] for i in usable]),
                    )
                    return v, drift

        usable = [
            i for i, p in enumerate(prns) if self._sats[p].doppler_hz is not None
        ]
        if len(usable) < 4:
            return None, None
        sat_pos = sat_pos_all[usable]
        sat_vel = np.empty((len(usable), 3))
        dopp = np.empty(len(usable))
        for j, i in enumerate(usable):
            rec = self._sats[prns[i]]
            sv_tow = self.observed_sv_time_of_week(prns[i])
            sat_vel[j] = rec.sv_velocity(
                sv_tow, kepler_iterations=self.config.kepler_iterations
            )
            dopp[j] = rec.doppler_hz
        v, drift = solve_velocity(
            sat_pos, sat_vel, rx_ecef, dopp,
            wavelengths_m=self._wavelengths_for([prns[i] for i in usable]),
        )
        return v, drift
