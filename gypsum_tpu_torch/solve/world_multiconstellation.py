"""WorldModel mixin: SBAS GEO + GLONASS ingestion and the dual solve.

Split from solve/world.py (round-4 verdict item 7). The non-GPS halves of
the world model: MT9/MT12 SBAS GEO navigation blocks, KX-verified GLONASS
strings (ephemeris assembly + time base), and the 5-unknown mixed
GPS/GLONASS position solve with its per-constellation clock biases.

No reference analogue (gypsum is GPS L1 C/A only).
"""

from __future__ import annotations

import logging

import numpy as np

from gypsum_tpu_torch.core.constants import (
    GPS_L1_FREQUENCY_HZ,
    SPEED_OF_LIGHT_M_PER_S as C,
)
from gypsum_tpu_torch.core.events import Event
from gypsum_tpu_torch.solve.fix import dilution_of_precision
from gypsum_tpu_torch.solve.geodesy import ecef_to_lla
from gypsum_tpu_torch.solve.world_records import (
    DeterminedSatelliteOrbitEvent,
    ReceiverSolution,
)

_logger = logging.getLogger(__name__)


class MultiConstellationMixin:
    """SBAS/GLONASS ingestion + dual-constellation solve for WorldModel."""

    def handle_sbas_block(
        self, prn: int, block, initial_ticks: int = 0
    ) -> list[Event]:
        """A CRC-verified SBAS block (nav/sbas.py SbasBlock) plays the role a
        decoded subframe plays for GPS: it resets the channel's PRN-tick time
        base at a known SV-time edge and (for MT9) supplies the GEO's orbit.

        SBAS blocks carry no time-of-week — their timing contract is that
        every 250-bit block's leading edge is emitted at an integer SNT
        second (DO-229 §A.4.4.1; SNT tracks GPS time within tens of ns). The
        integer is resolved from the GPS-derived receiver clock slide: the
        slide maps receiver to GPS time within one GPS SV's transit (~70 ms)
        plus the GEO/GPS transit difference (30-80 ms), far inside the
        +/-0.5 s rounding margin. Requires a GPS time base first (returns []
        and stays uncounted until one exists).

        ``initial_ticks``: PRN ticks the receiver already consumed between
        the block's trailing edge and the point this reset is applied (an
        SBAS block is verified up to ~30 ms after its trailing edge, which
        may fall in the previous tracking block — unlike GPS subframes,
        which always complete in-block)."""
        rec = self._record(prn)
        events: list[Event] = []
        if block.message_type == 1:
            from gypsum_tpu_torch.nav.sbas import parse_mt1_data

            mask = parse_mt1_data(block.data_bits)
            if self.sbas_corrections.mask is None:
                _logger.info(
                    "SBAS PRN %d MT1: correction mask for %d satellites "
                    "(IODP %d)", prn, len(mask.slots), mask.iodp,
                )
            self.sbas_corrections.handle_mask(mask)
        elif 2 <= block.message_type <= 5:
            from gypsum_tpu_torch.nav.sbas import parse_fast_corrections_data

            had = bool(self.sbas_corrections._by_slot)
            self.sbas_corrections.handle_fast(
                parse_fast_corrections_data(block.data_bits, block.message_type),
                rx_time=block.leading_edge_timestamp,
            )
            if not had and self.sbas_corrections._by_slot:
                _logger.info(
                    "SBAS PRN %d MT%d: fast corrections online for slots %s",
                    prn, block.message_type,
                    sorted(self.sbas_corrections._by_slot),
                )
        if block.message_type == 9:
            from gypsum_tpu_torch.nav.sbas import parse_mt9_data

            was = rec.geo
            rec.geo = parse_mt9_data(block.data_bits, prn)
            rec.orbit_version += 1
            if was is None:
                _logger.info(
                    "determined GEO orbit of SBAS PRN %d (MT9, t0=%.0f)",
                    prn, rec.geo.t0_sec_of_day,
                )
                events.append(
                    DeterminedSatelliteOrbitEvent(prn=prn, ephemeris=None)
                )
        if self.receiver_clock_slide is None:
            return events
        trailing_edge_rx = block.leading_edge_timestamp + 1.0
        # Nominal GEO transit 0.127 s minus the GPS transit (~0.072 s)
        # already folded into the slide: center the rounding window.
        guess = trailing_edge_rx + self.receiver_clock_slide - 0.055
        rec.tow_at_last_subframe = float(round(guess))
        rec.prn_ticks_since_subframe = int(initial_ticks)
        rec.counting = True
        seed = (
            rec.smoothed_delay_s
            if rec.smoothed_delay_s is not None
            else rec.code_phase_delay_s
        )
        rec.smoothed_delay_s = ((seed + 0.5e-3) % 1e-3) - 0.5e-3
        rec.smoothing_depth = max(rec.smoothing_depth, 1)
        return events

    def handle_glonass_string(
        self, prn: int, event, frequency_number: int, initial_ticks: int = 0
    ) -> list[Event]:
        """A KX-verified GLONASS navigation string (nav/glonass.py
        GlonassStringEvent) plays the GPS subframe's role for channel
        ``prn`` (201-214): its trailing edge sits on the 2 s GLONASS-time
        grid, anchoring the PRN-tick time base, and strings 1-4 of one frame
        assemble the broadcast state-vector ephemeris.

        Timing: string 1 carries tk (the frame start within the GLONASS
        day), so its trailing edge is at tk + 2 exactly; later strings are
        anchored by ROUNDING the receiver-measured elapsed time since that
        edge onto the 2 s grid (receiver clocks are parts-in-1e7 — the
        grid snap is unambiguous for hours). The GPS-frame sv time uses the
        deterministic UTC+3h/leap mapping; in a dual-constellation receiver
        the sub-us residual offset is solved as the per-constellation clock
        bias, and for a GLONASS-only receiver the GPS frame is simply a
        consistent internal timeline (the absolute week is unknowable
        without GPS, and cancels)."""
        from gypsum_tpu_torch.solve.glonass import (
            glonass_ephemeris_from_strings,
            gps_sow_from_glonass_day_time,
        )

        rec = self._record(prn)
        rec.leap_seconds = self.config.leap_seconds
        s = event.string
        edge_rx = event.trailing_edge_receiver_timestamp
        events: list[Event] = []

        if s.m == 1:
            rec.glo_tk = s.tk_seconds
            rec.glo_tk_edge_rx = edge_rx
            rec.glo_pending = {1: (s, edge_rx)}
        elif 2 <= s.m <= 4:
            rec.glo_pending[s.m] = (s, edge_rx)
            # Assemble once 1-4 are present and from one frame (<= 8 s span).
            if all(m in rec.glo_pending for m in (1, 2, 3, 4)):
                edges = [rec.glo_pending[m][1] for m in (1, 2, 3, 4)]
                if max(edges) - min(edges) < 8.5:
                    was = rec.glonass
                    rec.glonass = glonass_ephemeris_from_strings(
                        *(rec.glo_pending[m][0] for m in (1, 2, 3, 4)),
                        frequency_number=frequency_number,
                    )
                    rec.orbit_version += 1
                    if was is None:
                        _logger.info(
                            "determined orbit of GLONASS k=%+d (slot %d, tb %.0f)",
                            frequency_number, rec.glonass.slot, rec.glonass.tb_day_s,
                        )
                        events.append(
                            DeterminedSatelliteOrbitEvent(prn=prn, ephemeris=None)
                        )
                    self._flag_glonass_ghosts(prn, rec)
                rec.glo_pending = {
                    m: v for m, v in rec.glo_pending.items() if m == 1
                }

        if rec.glo_tk is None:
            return events  # cannot anchor time until a string 1 arrives

        # Edge instant on the 2 s GLONASS grid, then into the GPS frame.
        elapsed = edge_rx - rec.glo_tk_edge_rx
        edge_glo_day = rec.glo_tk + 2.0 + 2.0 * round(elapsed / 2.0)
        approx = (
            self.receiver_clock_slide + edge_rx
            if self.receiver_clock_slide is not None
            else edge_glo_day  # GLONASS-only: pick a consistent frame
        )
        tow = gps_sow_from_glonass_day_time(
            edge_glo_day, approx, self.config.leap_seconds
        )
        rec.tow_at_last_subframe = tow
        rec.prn_ticks_since_subframe = int(initial_ticks)
        rec.counting = True
        seed = (
            rec.smoothed_delay_s
            if rec.smoothed_delay_s is not None
            else rec.code_phase_delay_s
        )
        rec.smoothed_delay_s = ((seed + 0.5e-3) % 1e-3) - 0.5e-3
        rec.smoothing_depth = max(rec.smoothing_depth, 1)
        # Never let a GLONASS edge re-base a GPS-derived clock slide (the
        # two differ by the unsolved inter-system offset); set it only when
        # no slide exists at all (GLONASS-only operation).
        if self.receiver_clock_slide is None:
            self.receiver_clock_slide = tow - edge_rx
        return events

    def handle_glonass_l2_block(
        self,
        prn: int,
        code_phase_delay_s: float,
        doppler_hz: float | None,
        block_ms: int,
        receiver_timestamp: float,
        carrier_hz: float | None = None,
        cn0_dbhz: float | None = None,
    ) -> None:
        """Once-per-block L2OF channel observables (band="glonass_l2"
        receiver): maintain the Hatch-filtered L2 code delay on the L2
        carrier. The measured iono correction is formed lazily in
        ``_measurement_set`` from the wrapped L2-L1 difference — the true
        inter-band divergence is tens of meters (sub-us), far inside the
        1 ms wrap, so neither band needs a shared millisecond anchor."""
        from gypsum_tpu_torch.core.constants import GLONASS_L2_BASE_HZ

        rec = self._record(prn)
        f2 = carrier_hz or GLONASS_L2_BASE_HZ
        rec.l2_carrier_hz = f2
        rec.l2_updated_at = receiver_timestamp
        if cn0_dbhz is not None:
            rec.l2_cn0_dbhz = cn0_dbhz
        n_max = max(1, self.config.carrier_smoothing_window)
        if doppler_hz is None or rec.l2_delay_s is None:
            rec.l2_delay_s = code_phase_delay_s
            rec.l2_smoothing_depth = 1
            return
        dt = block_ms * 1e-3
        predicted = rec.l2_delay_s - (doppler_hz / f2) * dt
        innovation = ((code_phase_delay_s - predicted + 0.5e-3) % 1e-3) - 0.5e-3
        if abs(innovation) > 0.25e-3:
            rec.l2_delay_s = code_phase_delay_s
            rec.l2_smoothing_depth = 1
            return
        depth = min(rec.l2_smoothing_depth + 1, n_max)
        rec.l2_delay_s = predicted + innovation / depth
        rec.l2_smoothing_depth = depth

    def _update_iono_diff(self, rec) -> None:
        """Geometry-free accumulator: the wrapped L2-L1 difference is pure
        dispersive delay (+ noise), so it averages over the WHOLE track —
        far beyond the range-tracking Hatch window (the per-SV measured
        iono then stops costing accuracy on high-DOP geometries, where
        meter-level per-row noise is what GDOP amplifies). A >1 us
        innovation resets (iono cannot jump 300 m; a track reset can).

        Called from the L1 band's per-block update (world.py
        handle_channel_block), AFTER both bands' delays have advanced to
        the same block end — the L2 band steps first in a dual-band
        receiver, so sampling here is the only epoch-consistent point
        (sampling at the L2 update would difference against a one-block-
        stale L1 delay: code drift folds ~us of error into a tens-of-ns
        observable — measured: a 27 m fix error became 17 km)."""
        if rec.smoothed_delay_s is None or rec.l2_delay_s is None:
            return
        d_inst = ((rec.l2_delay_s - rec.smoothed_delay_s + 0.5e-3) % 1e-3) - 0.5e-3
        if rec.iono_diff_s is None:
            rec.iono_diff_s = d_inst
            rec.iono_diff_depth = 1
            return
        innov = ((d_inst - rec.iono_diff_s + 0.5e-3) % 1e-3) - 0.5e-3
        if abs(innov) > 1e-6:
            rec.iono_diff_s = d_inst
            rec.iono_diff_depth = 1
            return
        depth = min(rec.iono_diff_depth + 1, self.config.l2_iono_smoothing_window)
        rec.iono_diff_s += innov / depth
        rec.iono_diff_depth = depth

    def handle_lost_l2_lock(self, prn: int) -> None:
        """The L2OF channel dropped: invalidate ONLY the L2 half of the
        dual-frequency state — the satellite's L1 time base, smoothing and
        ephemeris are untouched (they belong to the L1 band's channel)."""
        rec = self._record(prn)
        rec.l2_delay_s = None
        rec.l2_smoothing_depth = 0
        rec.l2_updated_at = None
        rec.iono_diff_s = None
        rec.iono_diff_depth = 0

    def measured_iono_l1_s(
        self, prn: int, l1_delay_s: float, now: float
    ) -> float | None:
        """Dual-frequency measured L1 ionospheric group delay (seconds) for
        ``prn``, or None when unavailable/stale. Both bands see the same
        geometry and receiver clock, so the wrapped delay difference is
        purely the dispersive term: d = I2 - I1 = I1 (f1^2 - f2^2)/f2^2,
        i.e. I1 = d * f2^2/(f1^2 - f2^2). For GLONASS f2/f1 = 7/9 exactly,
        making the leverage factor f2^2/(f1^2-f2^2) = 49/32."""
        cfg = self.config
        rec = self._sats.get(prn)
        if (
            not cfg.dual_frequency_iono
            or rec is None
            or rec.l2_delay_s is None
            or rec.l2_updated_at is None
            or now - rec.l2_updated_at > cfg.l2_iono_max_age_s
            or rec.glonass is None
        ):
            return None
        f1 = rec.glonass.carrier_frequency_hz
        f2 = rec.l2_carrier_hz
        # Prefer the long-window geometry-free accumulator; fall back to
        # the instantaneous wrapped difference before it exists.
        if rec.iono_diff_s is not None:
            d = rec.iono_diff_s
        else:
            d = ((rec.l2_delay_s - l1_delay_s + 0.5e-3) % 1e-3) - 0.5e-3
        return float(d * f2 * f2 / (f1 * f1 - f2 * f2))

    def iono_vertical_gps_l1_m(
        self, receiver_timestamp: float, pos_est: np.ndarray
    ) -> float | None:
        """Thin-shell vertical (zenith) ionospheric delay at GPS L1, in
        meters, estimated from every FRESH GLONASS dual-frequency
        measurement: each slant measurement is scaled to GPS L1 by
        (f_glo/f_gps)^2 and divided by its obliquity
        (solve/iono.py:klobuchar_obliquity); the median over satellites is
        the local-sky estimate. None below two contributing satellites
        (a single ray cannot distinguish vertical delay from its own
        noise/mapping error). Requires a position estimate for the
        elevations — same contract as the model correction."""
        from gypsum_tpu_torch.solve.geodesy import elevation_azimuth
        from gypsum_tpu_torch.solve.iono import klobuchar_obliquity

        vals = []
        for prn, rec in self._sats.items():
            if (
                rec.glonass is None
                or not rec.counting
                or rec.smoothed_delay_s is None
                # Ghost channels (cross-channel FDMA leakage) carry
                # carrier/Doppler assumptions off by the sub-band spacing:
                # even with an L2 pair their slant iono is corrupted, so
                # they must not contribute to the vertical median that
                # corrects GPS rows.
                or rec.glonass_ghost
            ):
                continue
            iono_s = self.measured_iono_l1_s(
                prn, rec.smoothed_delay_s, now=receiver_timestamp
            )
            if iono_s is None:
                continue
            sv_tow = self.observed_sv_time_of_week(prn)
            sv_pos = rec.sv_position(
                sv_tow, kepler_iterations=self.config.kepler_iterations
            )
            el, _ = elevation_azimuth(pos_est, sv_pos)
            if el < 10.0:
                continue  # low rays: mapping error dominates
            i_gps_s = iono_s * (
                rec.glonass.carrier_frequency_hz / GPS_L1_FREQUENCY_HZ
            ) ** 2
            vals.append(C * i_gps_s / klobuchar_obliquity(el))
        if len(vals) < 2:
            return None
        return float(np.median(vals))

    def _flag_glonass_ghosts(self, prn: int, rec) -> None:
        """FDMA cross-channel ghost veto: every GLONASS satellite transmits
        the SAME 511-chip SP code, so a strong signal can leak into a
        vacant neighboring sub-band, false-acquire there, and decode the
        SAME navigation strings — two channels then claim one orbital slot
        (string 4). The weaker channel (C/N0) is the leakage image: flag
        it so the receiver drops it and the fix never ranges it
        (campaign-found failure: a ghost pseudorange moved a fix 335 m —
        the ghost's assumed sub-band carrier misestimates its Doppler/
        carrier-aiding by the 562.5 kHz channel spacing)."""
        slot = int(getattr(rec.glonass, "slot", 0) or 0)
        if slot < 1:
            return
        # GLOBAL arbitration per orbital slot (not pairwise): with >= 3
        # channels claiming one slot (a strong SV leaking into BOTH
        # adjacent vacant sub-bands), pairwise weaker/stronger overwrites
        # could un-flag a ghost that a stronger third claimant had
        # correctly flagged. Collect every claimant, keep only the single
        # max-C/N0 channel fix-eligible. Fresh re-vote each frame: flagged
        # channels keep tracking and decoding (just excluded from fixes),
        # so C/N0s stay live and a real satellite later claiming this
        # sub-band wins the re-vote.
        claimants = [
            (other_prn, other)
            for other_prn, other in self._sats.items()
            if other.glonass is not None
            and int(getattr(other.glonass, "slot", 0) or 0) == slot
        ]
        if len(claimants) < 2:
            rec.glonass_ghost = False
            return

        def _cn0(r) -> float:
            return r.cn0_dbhz if r.cn0_dbhz is not None else -1.0

        winner_prn, _ = max(claimants, key=lambda kv: _cn0(kv[1]))
        for other_prn, other in claimants:
            other.glonass_ghost = other_prn != winner_prn
        _logger.warning(
            "GLONASS slot %d decoded on %d FDMA channels (ids %s): keeping "
            "the strongest (id %d, C/N0 %.1f dBHz), flagging the rest as "
            "cross-channel ghosts",
            slot, len(claimants),
            [p for p, _ in claimants], winner_prn,
            _cn0(self._sats[winner_prn]),
        )

    def _compute_position_dual(
        self, receiver_timestamp: float, prns: list[int]
    ) -> ReceiverSolution | None:
        """Mixed GPS(+SBAS) / GLONASS epoch: 5-unknown solve with one clock
        bias per constellation (solve/fix.py:solve_position_multi). The
        integer-millisecond repair machinery is single-bias and does not run
        here; a grossly inconsistent mixed set is reported, not repaired
        (the single-constellation epochs around it carry the repair)."""
        from gypsum_tpu_torch.solve.fix import solve_position_multi

        cfg = self.config
        system_of = np.array(
            [1 if self._sats[p].glonass is not None else 0 for p in prns]
        )
        if len(prns) < 5:
            return None  # 5 unknowns
        pos = self.position_fixes[-1].ecef.copy() if self.position_fixes else np.zeros(3)
        biases = np.zeros(2)
        prev_pos = None
        for _ in range(cfg.outer_rounds):
            # _measurement_set already subtracts the STORED inter-system
            # bias from GLONASS rows, so each round solves residuals.
            sat_pos, transit = self._measurement_set(receiver_timestamp, prns, pos)
            pos, biases = solve_position_multi(
                sat_pos, transit, system_of,
                initial_position=pos, initial_biases=None,
                iterations=cfg.newton_iterations,
            )
            # Fold the GPS bias into the (GPS-anchored) clock slide and the
            # GLONASS-vs-GPS part into the persistent inter-system estimate
            # — the EKF and later epochs then consume corrected
            # pseudoranges (its single clock state models GPS only).
            self.receiver_clock_slide -= biases[0]
            self.glonass_bias_s += float(biases[1] - biases[0])
            if (
                prev_pos is not None
                and float(np.linalg.norm(pos - prev_pos)) < 1e-3
                and float(np.abs(biases).max()) * C < 1e-3
            ):
                break  # converged (see _compute_position)
            prev_pos = pos.copy()
        onehot_b = biases[system_of]
        ranges = np.linalg.norm(sat_pos - pos[None, :], axis=1)
        r = C * (transit - onehot_b) - ranges
        r -= r.mean()
        rms = float(np.sqrt(np.mean(r * r)))
        if rms > 1000.0:
            _logger.warning(
                "dual-constellation pseudorange set inconsistent (residual "
                "RMS %.0f m); publishing anyway (ms-repair is per-system)",
                rms,
            )
        lat, lon, alt = ecef_to_lla(pos)
        velocity, drift = self._solve_velocity(prns, pos, sat_pos)
        dop = dilution_of_precision(sat_pos, pos)
        from gypsum_tpu_torch.solve.integrity import protection_levels, raim_residual_test

        sigmas = np.array([self._sigma_for(p, now=receiver_timestamp) for p in prns])
        # Same RAIM gating as the single-constellation solve, with two clock
        # unknowns (r above is already the per-row post-fit residual).
        raim = raim_residual_test(
            sat_pos, pos, C * (transit - onehot_b) - ranges, sigmas, n_clocks=2
        )
        if raim is not None and not raim["ok"]:
            sigmas = sigmas * raim["sigma_scale"]
        protection = protection_levels(sat_pos, pos, sigmas)
        solution = ReceiverSolution(
            clock_bias_s=float(biases[0]),
            ecef=pos,
            lat_deg=lat,
            lon_deg=lon,
            alt_m=alt,
            satellites_used=tuple(prns),
            receiver_timestamp=receiver_timestamp,
            velocity_ecef_mps=velocity,
            clock_drift_s_per_s=drift,
            dop=dop,
            protection=protection,
            raim=raim,
            inter_system_bias_s=self.glonass_bias_s,
            iono_measured_m=dict(getattr(self, "_iono_measured_m", {})) or None,
        )
        self.position_fixes.append(solution)
        if self.config.ekf_enabled:
            self._ekf_shadow(receiver_timestamp, prns, solution)
        return solution

    def _wavelengths_for(self, prns: list[int]) -> np.ndarray:
        lams = np.empty(len(prns))
        for i, p in enumerate(prns):
            rec = self._sats[p]
            f = (
                rec.glonass.carrier_frequency_hz
                if rec.glonass is not None
                else GPS_L1_FREQUENCY_HZ
            )
            lams[i] = C / f
        return lams

