"""Vector-coast tier: open-loop channel holding + deep-integration ranging.

Mixin over Receiver (split out of runtime/receiver.py in round 5). The
failure-handling ladder a lost channel descends is:

    rescue (in place)  ->  coast (open loop)  ->  deep measurement  ->  drop

The reference drops on any lost lock (gypsum/receiver.py:248-267); the
coast tier instead drives the NCOs from the navigation solution's
predicted geometry (TrackingConfig.coast_*), re-measures the faded signal
by deep integration of the retained raw IQ (track/deepmeas.py), and only
drops when the signal stays absent past the deadline.
"""

from __future__ import annotations

import logging

import torch

from gypsum_tpu_torch.nav.bits import BitIntegrator
from gypsum_tpu_torch.nav.frames import SubframeDecoder
from gypsum_tpu_torch.runtime.pipeline import BlockReport, _ChannelPipeline
from gypsum_tpu_torch.track.loop import ChannelObservation

_logger = logging.getLogger(__name__)


class CoastMixin:
    """Coast entry/exit, open-loop prediction, and the deep-integration
    measurement of coasting channels. Host state it owns on the Receiver:
    ``_coast_raw`` (retained raw IQ), ``_coast_measurer``, ``_live_sig``,
    ``_coast_raw_dev`` (the last retained block on the device)."""

    def _enter_coast(self, obs: ChannelObservation, pipe: _ChannelPipeline,
                     t_end: float) -> bool:
        """Deep-integration tier above the rescue: a channel the watchdog
        declared lost is driven open-loop from the navigation solution's
        predicted geometry instead of dropped (TrackingConfig.coast_*).
        Requires a healthy anchor block, the SV's orbit, and a recent fix;
        decode state is rebuilt so bit/subframe sync restart cleanly on
        recovery. Returns True when the channel entered coast."""
        cfg = self.config.tracking
        if not cfg.coast_enabled or pipe.last_good is None:
            return False
        # Coast only a SIGNAL loss: a decode failure on a healthy signal
        # (quality still high) needs a decode restart, not open-loop NCOs —
        # keep the reference's drop semantics there.
        if float(obs.quality[-1]) >= cfg.rescue_quality_threshold:
            return False
        t0, cp0_s, fd0 = pipe.last_good
        if self.world.predicted_range_and_rate(obs.prn, t0) is None:
            return False  # no orbit / fix / slide to coast on
        fix = self.world.position_fixes[-1]
        if t_end - fix.receiver_timestamp > self.config.solver.geometry_reseed_max_fix_age_s:
            return False
        pipe.coast_started = t_end
        pipe.coast_measured_at = None
        pipe.deep_candidate_hz = None
        pipe.deep_streak = 0
        # Anchor holds ONLY the measured channel state; the geometry at t0
        # is re-evaluated under the CURRENT fix at every apply, so both ends
        # of the range delta share one model and fix errors cancel. (The
        # original design froze (rho0, rate0) at entry — computed from the
        # fix polluted by this very channel's corrupt dying-signal
        # pseudorange, whose garbage velocity estimate biased the anchored
        # range rate by ~15 m/s = a +78 Hz Doppler override no PLL pulls
        # in from.)
        pipe.coast_anchor = (t0, cp0_s, fd0)
        # Fresh decode stacks (family-appropriate): the queued noise symbols
        # are garbage, and a clean restart resyncs within seconds of
        # recovered signal.
        if pipe.glonass is not None:
            from gypsum_tpu_torch.nav.glonass import GlonassStringDecoder

            pipe.glonass = GlonassStringDecoder()
        elif pipe.sbas is not None:
            from gypsum_tpu_torch.nav.sbas import SbasFrameDecoder

            pipe.sbas = SbasFrameDecoder(obs.prn)
        else:
            pipe.integrator = BitIntegrator(self.config.nav)
            pipe.decoder = SubframeDecoder(self.config.nav)
        # In pipelined mode the in-flight block(s) run on the pre-edit
        # carry: predict for the instant the NEXT dispatch will start
        # (code-Doppler drift is samples-per-block — a one-block-stale
        # override puts the peak outside the lag window).
        t_apply = t_end + self.bank.pending_ms * 1e-3
        vals = self._apply_coast_state(obs.prn, pipe, t_apply)
        if vals is None:  # raced a fix invalidation; fall back to drop
            pipe.coast_started = None
            pipe.coast_anchor = None
            return False
        self.world.begin_coast(obs.prn, vals[0])
        _logger.info(
            "PRN %d signal lost (quality %.2f): coasting open-loop from "
            "predicted geometry", obs.prn, float(obs.quality[-1]),
        )
        return True

    def _coast_prediction(self, prn: int, pipe: _ChannelPipeline,
                          t: float) -> tuple[float, float] | None:
        """Predicted (sub-ms delay s, Doppler Hz) of a coasting channel at
        stream time ``t``. Both epochs of the geometry delta are evaluated
        under the CURRENT fix (see _enter_coast's anchor note)."""
        t0, cp0_s, fd0 = pipe.coast_anchor
        rr0 = self.world.predicted_range_and_rate(prn, t0)
        rr = self.world.predicted_range_and_rate(prn, t)
        if rr is None or rr0 is None:
            return None
        rho0, rate0 = rr0
        from gypsum_tpu_torch.core.constants import (
            GPS_L1_FREQUENCY_HZ,
            SPEED_OF_LIGHT_M_PER_S,
        )

        f_car = self._channel_carrier_hz.get(prn, GPS_L1_FREQUENCY_HZ)
        delay_s = (cp0_s + (rr[0] - rho0) / SPEED_OF_LIGHT_M_PER_S) % 1e-3
        doppler = fd0 - (rr[1] - rate0) * f_car / SPEED_OF_LIGHT_M_PER_S
        return delay_s, doppler

    def _apply_coast_state(self, prn: int, pipe: _ChannelPipeline,
                           t: float) -> tuple[float, float] | None:
        """Drive the channel's NCOs to the coast prediction at ``t`` = the
        instant the NEXT dispatched block will start."""
        vals = self._coast_prediction(prn, pipe, t)
        if vals is not None:
            self.bank.coast_override(
                pipe.slot, vals[0] * self.sample_rate, vals[1]
            )
        return vals

    def _process_coasting_channel(
        self,
        obs: ChannelObservation,
        block_start: float,
        block_ms: int,
        report: BlockReport,
        pipe: _ChannelPipeline,
    ) -> None:
        """One block of an open-loop channel: decide recovery / timeout /
        keep coasting, and feed the world model PREDICTED observables so the
        millisecond tick time base stays anchored (the SV is excluded from
        fixes by the coasting flag the whole time)."""
        from gypsum_tpu_torch.obs.cn0 import cn0_m2m4_dbhz

        cfg = self.config.tracking
        prn = obs.prn
        t_end = block_start + block_ms * 1e-3

        if float(obs.quality[-1]) >= cfg.coast_recovery_quality:
            # Signal returned: the loops were held aligned, so this block's
            # observables are already measurements — resume ranging now.
            coast_s = t_end - pipe.coast_started
            pipe.coast_started = None
            pipe.coast_anchor = None
            pipe.coast_measured_at = None
            pipe.deep_candidate_hz = None
            pipe.deep_streak = 0
            self.world.end_coast(prn)
            f_car = self._channel_carrier_hz.get(prn)
            cp_delay, doppler = self._block_end_observables(obs, carrier_hz=f_car)
            self.world.handle_channel_block(
                prn, cp_delay, doppler, block_ms,
                cn0_dbhz=cn0_m2m4_dbhz(obs.prompts),
                carrier_hz=f_car,
            )
            self.world.handle_prn_observed(
                prn, cp_delay, count=block_ms, doppler_hz=doppler
            )
            if self.world.seed_time_base_from_geometry(prn, t_end):
                report.reseeded_prns.append(prn)
            pipe.last_good = (t_end, cp_delay, doppler)
            report.coast_recovered_prns.append(prn)
            _logger.info(
                "PRN %d signal returned after %.1f s coast: ranging resumed "
                "in place (quality %.2f)", prn, coast_s, float(obs.quality[-1]),
            )
            return

        # Deep-integration measurement of this block's raw IQ around the
        # prediction (track/deepmeas.py): a detection re-anchors the coast
        # (bounding open-loop drift), refreshes the give-up deadline (the
        # signal is present, just below the loops' threshold), and feeds the
        # world model a GENUINE pseudorange instead of the prediction.
        deep = None
        if cfg.coast_deep_measurement:
            deep = self._deep_coast_measurement(obs, pipe, block_start, block_ms)

        # Multi-block confirmation: a single-block detection is only a
        # CANDIDATE; it acts (re-anchor, fix admission, deadline refresh)
        # once coast_meas_confirm_blocks consecutive blocks agree in Doppler.
        # Sidelobe/noise artifacts that slip past the gates do not repeat
        # coherently, while a real weak signal re-detects every block.
        if deep is not None:
            consistent = (
                pipe.deep_candidate_hz is not None
                and abs(deep[1] - pipe.deep_candidate_hz)
                <= cfg.coast_meas_confirm_tol_hz
            )
            pipe.deep_streak = pipe.deep_streak + 1 if consistent else 1
            pipe.deep_candidate_hz = deep[1]
            if pipe.deep_streak < int(cfg.coast_meas_confirm_blocks):
                deep = None
        else:
            pipe.deep_candidate_hz = None
            pipe.deep_streak = 0

        if deep is None:
            last_progress = max(
                pipe.coast_started, pipe.coast_measured_at or pipe.coast_started
            )
            if t_end - last_progress > cfg.coast_max_s:
                _logger.info(
                    "PRN %d coast timed out after %.1f s without signal: dropping",
                    prn, t_end - pipe.coast_started,
                )
                self._drop_satellite(prn, report)
                return

        if deep is not None:
            delay_s, doppler = deep
            pipe.coast_anchor = (t_end, delay_s, doppler)
            pipe.coast_measured_at = t_end
            self.world.set_deep_ranging(prn, True)
            report.deep_measured_prns.append(prn)
        else:
            self.world.set_deep_ranging(prn, False)

        if self._apply_coast_state(
            prn, pipe, t_end + self.bank.pending_ms * 1e-3
        ) is None:
            self._drop_satellite(prn, report)
            return
        # World-model observables are evaluated at the PROCESSED block's end
        # (the override above targets the next dispatch instead, which in
        # pipelined mode is later). Measured observables (deep) or predicted
        # ones (keeping the tick time base anchored); C/N0 comes from the
        # real (faded) prompts so metrics show the outage.
        if deep is None:
            delay_s, doppler = self._coast_prediction(prn, pipe, t_end)
        self.world.handle_channel_block(
            prn, delay_s, doppler, block_ms,
            cn0_dbhz=cn0_m2m4_dbhz(obs.prompts),
        )
        self.world.handle_prn_observed(
            prn, delay_s, count=block_ms, doppler_hz=doppler
        )
        report.coasting_prns.append(prn)

    def _deep_coast_measurement(
        self,
        obs: ChannelObservation,
        pipe: _ChannelPipeline,
        block_start: float,
        block_ms: int,
    ) -> tuple[float, float] | None:
        """Measure a coasting channel's (sub-ms delay s, Doppler Hz) at the
        block's end from the retained raw IQ (track/deepmeas.py). None when
        no raw block was retained (first coasting block), the prediction is
        unavailable, or nothing cleared the detection gate."""
        raw = self._coast_raw.get(int(round(block_start * 1e3)))
        if raw is None:
            return None
        t_end = block_start + block_ms * 1e-3
        p0 = self._coast_prediction(obs.prn, pipe, block_start)
        p1 = self._coast_prediction(obs.prn, pipe, t_end)
        if p0 is None or p1 is None:
            return None
        d0, f0 = p0
        d1, f1 = p1
        fs = self.sample_rate
        drift = (((d1 - d0) + 0.5e-3) % 1e-3 - 0.5e-3) * fs
        off = pipe.carrier_offset_hz

        def measure():
            if self._coast_measurer is None:
                from gypsum_tpu_torch.track.deepmeas import DeepCoastMeasurer

                self._coast_measurer = DeepCoastMeasurer(
                    fs, self.samples_per_prn, self.bank.prns, self.bank.config,
                    device=self.device,
                )
            # The retained block crosses to the device once, for every
            # channel that coasts in it (the pageable upload is the largest
            # device item of a replay).
            key = int(round(block_start * 1e3))
            if self._coast_raw_dev is None or self._coast_raw_dev[0] != key:
                self._coast_raw_dev = (key, torch.from_numpy(raw).to(self.device))
            # FDMA channels sit at their sub-band offset in baseband: the
            # static offset is wiped separately in float64 inside the
            # measurer (float32 chunk phases at MHz offsets would cost ~45°
            # of per-ms jitter on exactly the weak-signal path that needs
            # coherence); only the kHz-scale Doppler grid reaches the
            # float32 wipeoff.
            return self._coast_measurer.measure(
                self._coast_raw_dev[1],
                obs.prn,
                (d0 * fs) % self.samples_per_prn,
                drift,
                0.5 * (f0 + f1),
                static_offset_hz=off,
            )

        # In mesh mode rank 0 measures and every rank gets its result.
        res = self._agreed(measure)
        if res is None or not res.detected:
            return None
        from gypsum_tpu_torch.track.deepmeas import xcorr_suspect

        cfg = self.config.tracking
        live = [v for p, v in self._live_sig.items() if p != obs.prn]
        if live and xcorr_suspect(
            off + res.doppler_hz,
            res.peak_abs,
            res.groups,
            int(cfg.coast_meas_coherent_ms),
            live,
            float(cfg.coast_meas_xcorr_tol_hz),
            float(cfg.coast_meas_xcorr_margin),
        ):
            _logger.info(
                "PRN %d deep detection (strength %.2f, %.1f Hz) vetoed: "
                "Doppler-consistent with a live channel's cross-correlation "
                "sidelobes", obs.prn, res.strength, res.doppler_hz,
            )
            return None
        delay_end = (d1 + res.cp_error_samples / fs) % 1e-3
        return delay_end, res.doppler_hz
