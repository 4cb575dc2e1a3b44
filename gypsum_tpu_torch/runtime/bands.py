"""Per-band channel processors: GLONASS L1OF, GLONASS L2OF, SBAS GEO.

Mixin over Receiver (split out of runtime/receiver.py in round 5). The GPS
L1 C/A processor stays in receiver.py (_process_channel) as the template
these variants deviate from: same tracking observables and PRN-tick
accounting, different decode stack and time-base edge semantics.
"""

from __future__ import annotations

import logging

import numpy as np

from gypsum_tpu_torch.runtime.pipeline import BlockReport, _ChannelPipeline
from gypsum_tpu_torch.track.loop import ChannelObservation

_logger = logging.getLogger(__name__)


class BandProcessorsMixin:
    def _process_l2_channel(
        self,
        obs: ChannelObservation,
        block_start: float,
        block_ms: int,
        report: BlockReport,
        pipe: _ChannelPipeline,
    ) -> None:
        """GLONASS L2OF channel: tracking only — the block-end code delay
        feeds the world model's per-SV L1/L2 difference (the dispersive
        ionosphere measured directly, no Klobuchar model or broadcast
        needed; solve/world_multiconstellation.py:handle_glonass_l2_block).
        No decode stack: the L2OF nav message duplicates L1OF's. Lost
        channels simply drop and reacquire — the iono correction has a
        model fallback, so an L2 outage never needs the coast tier."""
        from gypsum_tpu_torch.obs.cn0 import cn0_m2m4_dbhz
        from gypsum_tpu_torch.signal.prn import glonass_frequency_number

        f_car = self._channel_carrier_hz.get(obs.prn)
        cp_delay, doppler = self._block_end_observables(obs, carrier_hz=f_car)
        self.world.handle_glonass_l2_block(
            obs.prn, cp_delay, doppler, block_ms,
            receiver_timestamp=block_start + block_ms * 1e-3,
            carrier_hz=f_car,
            cn0_dbhz=cn0_m2m4_dbhz(obs.prompts),
        )
        if obs.lost:
            # L2-only drop: release the channel but leave the shared L1
            # record's time base/smoothing untouched (only the L2 half of
            # the iono difference is invalidated).
            self.pipelines.pop(obs.prn)
            self.bank.release(pipe.slot)
            self.world.handle_lost_l2_lock(obs.prn)
            self.eligible_prns.add(obs.prn)
            report.dropped_prns.append(obs.prn)
            _logger.info(
                "dropped GLONASS L2 channel k=%+d (lost lock); returned to "
                "acquisition pool", glonass_frequency_number(obs.prn),
            )
        elif self.bank.maybe_rescue(obs, block_start + block_ms * 1e-3):
            report.rescued_prns.append(obs.prn)
            _logger.info(
                "rescued marginal GLONASS L2 channel k=%+d in place (quality %.2f)",
                glonass_frequency_number(obs.prn), float(obs.quality[-1]),
            )

    def _process_glonass_channel(
        self,
        obs: ChannelObservation,
        block_start: float,
        block_ms: int,
        report: BlockReport,
        pipe: _ChannelPipeline,
    ) -> None:
        """GLONASS channel: same tracking observables and tick accounting as
        GPS, but the decode stack is the string decoder (nav/glonass.py) and
        a KX-verified string's trailing edge — on the 2 s GLONASS grid —
        plays the subframe edge's role in the time base
        (solve/world.py:handle_glonass_string)."""
        from gypsum_tpu_torch.obs.cn0 import cn0_m2m4_dbhz
        from gypsum_tpu_torch.signal.prn import glonass_frequency_number

        # An FDMA cross-channel ghost (world_multiconstellation.
        # _flag_glonass_ghosts) keeps TRACKING and DECODING here — it is
        # excluded from fixes by _fix_ready_satellites, and every new
        # frame re-runs the slot-collision arbitration with fresh C/N0s,
        # so a real satellite appearing on the sub-band later reclaims it
        # without the acquire/drop churn an eager drop would cause.
        events = pipe.glonass.process_block(
            obs.pseudosymbol_signs.astype(np.float64), obs.start_times
        )
        f_car = self._channel_carrier_hz.get(obs.prn)
        cp_delay, doppler = self._block_end_observables(obs, carrier_hz=f_car)
        # TDCP phase advance deliberately omitted: the NCO replay law
        # changes under an FDMA offset; GLONASS rows use the Doppler
        # velocity fallback (with their own wavelength, solve/velocity.py).
        self.world.handle_channel_block(
            obs.prn, cp_delay, doppler, block_ms,
            cn0_dbhz=cn0_m2m4_dbhz(obs.prompts),
            carrier_hz=f_car,
        )
        k = glonass_frequency_number(obs.prn)
        consumed = 0
        for ev in events:  # emitted in edge order
            t_edge = ev.trailing_edge_receiver_timestamp
            k_raw = int(np.floor((t_edge - block_start) / 1e-3))
            # The decoder needs ~2.3 s buffered past a string before it can
            # emit it, so an edge may precede this block: those ticks were
            # counted against the old anchor — hand them to the reset.
            late_ticks = max(0, -k_raw)
            k_done = max(0, min(k_raw, block_ms))
            if k_done > consumed:
                self.world.handle_prn_observed(
                    obs.prn, cp_delay, count=k_done - consumed, doppler_hz=doppler
                )
                consumed = k_done
            self.world.handle_glonass_string(
                obs.prn, ev, frequency_number=k, initial_ticks=late_ticks
            )
            self.subframe_count += 1
            report.glonass_strings.append((obs.prn, ev))
        if block_ms > consumed:
            self.world.handle_prn_observed(
                obs.prn, cp_delay, count=block_ms - consumed, doppler_hz=doppler
            )
        if not obs.lost and float(obs.quality[-1]) >= self.config.tracking.rescue_quality_threshold:
            pipe.last_good = (block_start + block_ms * 1e-3, cp_delay, doppler)
        if obs.lost:
            if self._enter_coast(obs, pipe, block_start + block_ms * 1e-3):
                report.coasting_prns.append(obs.prn)
            else:
                self._drop_satellite(obs.prn, report)
        elif self.bank.maybe_rescue(obs, block_start + block_ms * 1e-3):
            report.rescued_prns.append(obs.prn)
            _logger.info(
                "rescued marginal GLONASS channel k=%+d in place (quality %.2f)",
                k, float(obs.quality[-1]),
            )

    def _process_sbas_channel(
        self,
        obs: ChannelObservation,
        block_start: float,
        block_ms: int,
        report: BlockReport,
        pipe: _ChannelPipeline,
    ) -> None:
        """SBAS GEO channel: same tracking observables and tick accounting as
        GPS, but the decode stack is the DO-229 frame decoder (nav/sbas.py)
        and a verified block's trailing edge plays the subframe edge's role
        in the time base (solve/world.py handle_sbas_block)."""
        blocks = pipe.sbas.process_block(obs.prompts.real, obs.start_times)
        cp_delay, doppler = self._block_end_observables(obs)
        from gypsum_tpu_torch.obs.cn0 import cn0_m2m4_dbhz

        self.world.handle_channel_block(
            obs.prn, cp_delay, doppler, block_ms,
            cn0_dbhz=cn0_m2m4_dbhz(obs.prompts),
        )
        consumed = 0
        for blk in blocks:
            t_edge = blk.leading_edge_timestamp + 1.0  # trailing edge (1 s blocks)
            k_raw = int(np.floor((t_edge - block_start) / 1e-3))
            # An SBAS block verifies ~30 ms after its trailing edge, which may
            # fall in the PREVIOUS tracking block: those ticks were already
            # counted against the old base, so hand them to the reset.
            late_ticks = max(0, -k_raw)
            k_done = max(0, min(k_raw, block_ms))
            if k_done > consumed:
                self.world.handle_prn_observed(
                    obs.prn, cp_delay, count=k_done - consumed, doppler_hz=doppler
                )
                consumed = k_done
            self.world.handle_sbas_block(obs.prn, blk, initial_ticks=late_ticks)
            self.subframe_count += 1
            report.sbas_blocks.append((obs.prn, blk))
        if block_ms > consumed:
            self.world.handle_prn_observed(
                obs.prn, cp_delay, count=block_ms - consumed, doppler_hz=doppler
            )
        if not obs.lost and float(obs.quality[-1]) >= self.config.tracking.rescue_quality_threshold:
            pipe.last_good = (block_start + block_ms * 1e-3, cp_delay, doppler)
        if obs.lost:
            if self._enter_coast(obs, pipe, block_start + block_ms * 1e-3):
                report.coasting_prns.append(obs.prn)
            else:
                self._drop_satellite(obs.prn, report)
        elif self.bank.maybe_rescue(obs, block_start + block_ms * 1e-3):
            report.rescued_prns.append(obs.prn)
            _logger.info(
                "rescued marginal SBAS PRN %d in place (quality %.2f)",
                obs.prn, float(obs.quality[-1]),
            )
