"""The receiver master loop (GPS L1 C/A, GLONASS L1OF and L2OF bands).

Torch port of gypsum_tpu/runtime/receiver.py. Reference behavior being
reproduced (gypsum/receiver.py): maintain an acquisition pool and
per-satellite pipelines; scan for new satellites every 10 s of signal time
over 10 ms of buffered samples; track acquired satellites; feed pseudosymbols
through bit integration, subframe decode and the world model; drop
satellites on lost lock and return them to the pool; attempt a position fix
continuously.

The loop advances one *block* (default 1000 ms) per iteration: one device
dispatch tracks every channel for the whole block and at most one runs
acquisition; the navigation layers then run on the host over the block's
outputs. Satellite add/drop happens at block boundaries.

PRN-tick bookkeeping across a block: the world model's per-SV time base
counts 1 ms PRN observations since the last handover word and must be reset
*between* ticks when a subframe lands mid-block. Subframe trailing-edge
timestamps are code-phase corrected, so the completion chunk index within the
block is ``floor((t_edge - block_start) / 1ms) - 1``; ticks are credited
around each subframe event in order (gypsum/receiver.py:106-117 does the
same accounting by interleaving 1 ms steps).

The receiver is the composition root over runtime/pipeline.py (per-channel
decode state, BlockReport), runtime/coast.py (the vector-coast tier),
runtime/bands.py (the GLONASS L1OF/L2OF and SBAS GEO channel processors)
and runtime/dualband.py (DualBandReceiver, re-exported here).
"""

from __future__ import annotations

import dataclasses
import logging

import numpy as np

import torch

from gypsum_tpu_torch.acquire.engine import shared_acquisition_engine
from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.core.constants import (
    GLONASS_L1_BASE_HZ,
    GLONASS_L1_CHANNEL_SPACING_HZ,
    GLONASS_L2_BASE_HZ,
    GLONASS_L2_CHANNEL_SPACING_HZ,
)
from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.core.events import (
    CannotDetermineBitPhaseEvent,
    CannotDetermineSubframePhaseEvent,
    EmitNavigationBitEvent,
    LostBitCoherenceEvent,
    NoMoreSamplesError,
)
from gypsum_tpu_torch.io.sources import SampleSource
from gypsum_tpu_torch.nav.bits import BitIntegrator
from gypsum_tpu_torch.nav.frames import EmitSubframeEvent, SubframeDecoder
from gypsum_tpu_torch.nav.glonass import GlonassStringDecoder
from gypsum_tpu_torch.runtime.bands import BandProcessorsMixin
from gypsum_tpu_torch.runtime.coast import CoastMixin
from gypsum_tpu_torch.runtime.pipeline import BlockReport, _ChannelPipeline  # noqa: F401  (re-export)
from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS, GLONASS_PRN_IDS, glonass_frequency_number
from gypsum_tpu_torch.solve.world import WorldModel
from gypsum_tpu_torch.track.loop import ChannelObservation, TrackerBank

_logger = logging.getLogger(__name__)


class Receiver(CoastMixin, BandProcessorsMixin):
    def __init__(
        self,
        source: SampleSource,
        config: ReceiverConfig | None = None,
        eligible_prns: list[int] | None = None,
        band: str = "gps",
        world: WorldModel | None = None,
        attempt_fixes: bool = True,
        device: str | torch.device = "cuda",
        mesh=None,
    ) -> None:
        """``band``: "gps" (L1 C/A + SBAS family, the default), "glonass"
        (the L1OF FDMA band at 1602 MHz: its own source, acquisition
        centers, tracker carrier offsets and string-decode pipeline), or
        "glonass_l2" (the L2OF band at 1246 MHz: the SAME 511-chip code, so
        the channels track but never decode; they contribute the per-SV L2
        code delay the world model differences against L1 for the MEASURED
        ionospheric correction, solve/world_multiconstellation.py).

        ``world``: share a WorldModel across receivers (DualBandReceiver
        runs one Receiver per band into one world model and one fix);
        ``attempt_fixes=False`` makes this receiver contribute observations
        without racing the owner's fix attempts.

        ``device``: where acquisition and tracking run ("cuda" by default;
        raises when no card is present, pass "cpu" to run on the CPU).

        ``mesh``: a ('sat', 'time') DeviceMesh (parallel/mesh.py); this
        process is then one rank of an SPMD run, ``device`` its own. The
        tracking bank runs in mesh mode (each rank tracks its slice of the
        channels, the block's state and outputs are gathered whole on every
        rank), and the device results that steer the host (acquisition
        hits, the coast tier's deep measurements) are computed on rank 0
        and broadcast, so every rank takes the same decisions on the same
        bytes and reaches the same collectives. Every rank must be built
        alike and read the same samples."""
        if band not in ("gps", "glonass", "glonass_l2"):
            raise ValueError(f"unknown band {band!r} (gps | glonass | glonass_l2)")
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = config or ReceiverConfig()
        self.band = band
        self.source = source
        attrs = source.attributes
        self.sample_rate = attrs.sample_rate
        self.samples_per_prn = attrs.samples_per_prn
        self._attempt_fixes = attempt_fixes

        tracking_cfg = self.config.tracking
        acq_offsets = None
        if band in ("glonass", "glonass_l2"):
            base_hz, spacing_hz = (
                (GLONASS_L2_BASE_HZ, GLONASS_L2_CHANNEL_SPACING_HZ)
                if band == "glonass_l2"
                else (GLONASS_L1_BASE_HZ, GLONASS_L1_CHANNEL_SPACING_HZ)
            )
            requested = set(eligible_prns or GLONASS_PRN_IDS)
            bad = requested - set(GLONASS_PRN_IDS)
            if bad:
                raise ValueError(f"not GLONASS channel ids (201..214): {sorted(bad)}")
            self.prn_family = GLONASS_PRN_IDS
            acq_offsets = tuple(
                float(glonass_frequency_number(p) * spacing_hz)
                for p in self.prn_family
            )
            self._channel_offset_hz = dict(zip(self.prn_family, acq_offsets))
            self._channel_carrier_hz = {
                p: base_hz + off for p, off in self._channel_offset_hz.items()
            }
            if tracking_cfg.aiding_carrier_hz is None:
                tracking_cfg = dataclasses.replace(tracking_cfg, aiding_carrier_hz=base_hz)
            if tracking_cfg.chips_per_code == 1023:
                # L1OF short code: 511 chips per 1 ms period.
                tracking_cfg = dataclasses.replace(tracking_cfg, chips_per_code=511)
        else:
            # The searched/tracked PRN family: the 32 GPS SVs, widened to
            # include any SBAS (or other registered C/A-family) PRNs the
            # caller asks for.
            requested = set(eligible_prns or ALL_PRN_IDS)
            extra = requested - set(ALL_PRN_IDS)
            self.prn_family: tuple[int, ...] = (
                tuple(sorted(set(ALL_PRN_IDS) | extra)) if extra else ALL_PRN_IDS
            )
            self._channel_offset_hz: dict[int, float] = {}
            self._channel_carrier_hz: dict[int, float] = {}
        self.acquisition = shared_acquisition_engine(
            self.sample_rate, self.samples_per_prn, self.config.acquisition,
            prns=self.prn_family, center_offsets_hz=acq_offsets, device=self.device,
        )
        # Integer captures ship raw words to the device and dequantize there
        # (core/planes.py:dequantize_planes): 4x less host->device traffic
        # for 8-bit SDR formats.
        info = getattr(source, "info", None)
        self._input_offset = float(getattr(info, "component_offset", 0.0) or 0.0)
        self.bank = TrackerBank(
            self.sample_rate,
            self.samples_per_prn,
            tracking_cfg,
            n_channels=self.config.max_channels,
            input_offset=self._input_offset,
            prns=self.prn_family,
            device=self.device,
            mesh=mesh,
        )
        self.world = world if world is not None else WorldModel(self.config.solver)
        # Spoofing monitors (solve/spoofing.py): detection-only watchdogs.
        self.spoofing = None
        if self.config.spoofing.enabled:
            from gypsum_tpu_torch.solve.spoofing import SpoofingMonitor

            self.spoofing = SpoofingMonitor(self.config.spoofing)
        # reference: gypsum/receiver.py:61-64.
        self.eligible_prns: set[int] = set(requested)
        self.pipelines: dict[int, _ChannelPipeline] = {}
        self._last_scan_time: float | None = None
        self.block_reports: list[BlockReport] = []
        self.subframe_count = 0
        self._block_listeners = []
        # Depth-1 software pipeline over the host/device boundary
        # (TrackingConfig.pipeline_tracking): dispatch block k, then process
        # block k-1's observations while k computes (collecting k-1 waits
        # only for k-1's own output copy, track/loop.py:dispatch_block).
        # None = on for the card, off on the CPU.
        pipelined = self.config.tracking.pipeline_tracking
        if pipelined is None:
            pipelined = self.device.type == "cuda"
        self._pipeline_depth = 1 if pipelined else 0
        # One-block read-ahead (TrackingConfig.async_upload): block k+1's
        # samples are copied to the card from pinned memory on a side
        # stream while block k computes and k-1 is processed.
        self._async_upload = bool(self.config.tracking.async_upload)
        self._upload_stream = None
        self._readahead = None  # (start, track_input, block, planes, offset, fut)
        self._readahead_eof = False
        # Deep-integration measurement on coasting channels
        # (track/deepmeas.py): raw IQ of in-flight blocks is retained (host
        # side, keyed by integer ms of block start; complex, or integer
        # planes with their offset) while any channel coasts or, pipelined,
        # always, so the collected block can be re-correlated around the
        # coast prediction. The measurer is built lazily on first use.
        self._coast_raw: dict[int, np.ndarray | tuple[np.ndarray, float]] = {}
        # (block key, tensor): the retained block being measured, uploaded
        # once for all of its coasting channels.
        self._coast_raw_dev: tuple[int, torch.Tensor] | None = None
        self._coast_measurer = None
        # Healthy channels' (absolute Doppler Hz, per-ms prompt magnitude)
        # from the last collected block — the cross-correlation veto input.
        self._live_sig: dict[int, tuple[float, float]] = {}

    # ------------------------------------------------------------ lifecycle

    def add_block_listener(self, fn) -> None:
        """fn(receiver, BlockReport) called after every block (metrics/UI)."""
        self._block_listeners.append(fn)

    def run(self, max_seconds: float | None = None, until_fix: bool = False) -> list[BlockReport]:
        """Process the stream until exhaustion / ``max_seconds`` / first fix."""
        start = self.stream_position_s
        stop = False
        while not stop:
            if max_seconds is not None and self.stream_position_s - start >= max_seconds:
                break
            try:
                report = self.step_block()
            except NoMoreSamplesError:
                break
            if until_fix and report.fix is not None:
                stop = True
        # Drain the pipeline: process dispatched-but-uncollected blocks so
        # the world model / checkpoints reflect every consumed sample
        # (required even after an until_fix stop — a checkpoint taken with
        # blocks in flight would skip their samples on resume).
        while self.bank.pending_blocks:
            self._drain_one()
        return self.block_reports

    def _drain_one(self) -> BlockReport:
        pend = self.bank._pending[0]
        report = BlockReport(block_start=pend.start_time,
                             block_end=pend.start_time + pend.n_ms * 1e-3)
        self._collect_into(report)
        self.block_reports.append(report)
        for fn in self._block_listeners:
            fn(self, report)
        return report

    def _agreed(self, compute):
        """``compute()``, a device result that steers the host: in mesh mode
        run on rank 0 only and broadcast, so every rank holds the same
        bytes (parallel/mesh.py:broadcast_from_rank0)."""
        if self.mesh is None:
            return compute()
        from gypsum_tpu_torch.parallel.mesh import broadcast_from_rank0

        return broadcast_from_rank0(compute, self.device)

    # ------------------------------------------------------------- the loop

    @property
    def stream_position_s(self) -> float:
        """Stream position EXCLUDING any read-ahead block that has not been
        dispatched yet (run() bounds and checkpoints must not count it — a
        dropped read-ahead is simply re-read on resume)."""
        pos = self.source.seconds_consumed
        if self._readahead is not None:
            pos -= self._readahead[1].shape[0] * 1e-3
        return pos

    def _read_raw(self, block_ms: int):
        """(block_start, track_input, block_complex|None, planes|None, offset)"""
        raw = self.source.read_block_quantized(block_ms)
        if raw is None:
            block_start, block = self.source.read_block(block_ms)
            return block_start, block, block, None, 0.0
        block_start, planes, offset = raw
        return block_start, planes, None, planes, offset

    def _submit_upload(self, track_input) -> "_Upload":
        """Start the host->device copy of one block's samples (complex or
        raw planes). On the card it runs from pinned memory on a side
        stream; ``result()`` makes the current stream wait for it."""
        arr = np.ascontiguousarray(track_input)
        if np.iscomplexobj(arr):
            arr = arr.astype(np.complex64, copy=False)
        host = torch.from_numpy(arr)
        if self.device.type != "cuda":
            return _Upload(host, None)
        if self._upload_stream is None:
            self._upload_stream = torch.cuda.Stream(device=self.device)
        pinned = host.pin_memory()
        with torch.cuda.stream(self._upload_stream):
            dev = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._upload_stream)
        # The pinned buffer must outlive the copy: the upload holds it.
        return _Upload(dev, done, pinned)

    def step_block(self) -> BlockReport:
        block_ms = self.config.tracking.block_size_ms
        upload_fut = None
        if self._readahead is not None:
            block_start, track_input, block, planes, offset, upload_fut = self._readahead
            self._readahead = None
        elif self._readahead_eof:
            self._readahead_eof = False
            raise NoMoreSamplesError("stream exhausted (past read-ahead)")
        else:
            block_start, track_input, block, planes, offset = self._read_raw(block_ms)
        block_end = block_start + track_input.shape[0] * 1e-3
        report = BlockReport(block_start=block_start, block_end=block_end)

        # Retain this block's raw IQ (host side) while any channel coasts:
        # the deep-integration measurement (track/deepmeas.py) re-correlates
        # the COLLECTED block. Pipelined, every block is retained while it is
        # in flight: a channel that enters coast on the block collected below
        # is measured on THIS block next, and the coast decision comes after
        # this dispatch (deciding here would start its measurements one block
        # later than unpipelined). Integer planes are kept as read and
        # converted only if measured (runtime/coast.py:_retained_block).
        if self.config.tracking.coast_deep_measurement and (
            self._pipeline_depth
            or any(p.coast_started is not None for p in self.pipelines.values())
        ):
            self._coast_raw[int(round(block_start * 1e3))] = (
                block if block is not None else (planes, offset)
            )

        # --- acquisition scan (reference: gypsum/receiver.py:148-174) over
        # the first 10 ms of this block; tracker state then starts at the
        # window it was measured on.
        if self._should_scan(block_start):
            self._last_scan_time = block_start
            if block is None:
                n = min(self.config.acquisition.integration_period_ms, planes.shape[0])
                head = planes[:n].astype(np.float32) - offset
                block = (head[..., 0] + 1j * head[..., 1]).astype(np.complex64)
            self._acquire(block, block_start, report)

        # --- vestigial-peak spoofing scan over the same snapshot cadence
        # (solve/spoofing.py): tracked PRNs, tracked peak excluded.
        if self.spoofing is not None and self.spoofing.should_scan(block_start):
            n = min(self.config.acquisition.integration_period_ms,
                    track_input.shape[0])
            if block is None:
                head = planes[:n].astype(np.float32) - offset
                blk = (head[..., 0] + 1j * head[..., 1]).astype(np.complex64)
            else:
                blk = block[:n]
            from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ

            # The record's code phase is the END of the last COLLECTED
            # block; in pipelined mode that is a full block behind this
            # scan's samples, and code-Doppler drift (~4 samples/s at 3 kHz
            # Doppler) would displace the true peak outside the scan's
            # tracked-peak exclusion window — flagging the SV's own signal
            # as a vestigial (false spoofing alarm on every clean pipelined
            # replay). Project each delay forward over the staleness.
            stale_s = (
                block_start - self.bank._pending[0].start_time
                if self.bank._pending else 0.0
            )
            tracked = {}
            for prn in self.pipelines:
                rec = self.world._sats.get(prn)
                if rec is not None and rec.doppler_hz is not None:
                    f_car = self._channel_carrier_hz.get(prn, GPS_L1_FREQUENCY_HZ)
                    delay = rec.code_phase_delay_s - rec.doppler_hz / f_car * stale_s
                    cp = (delay * self.sample_rate) % self.samples_per_prn
                    tracked[prn] = (cp, rec.doppler_hz)
            if tracked:
                alerts = self.spoofing.vestigial_scan(
                    blk, self.sample_rate, tracked, block_start
                )
                report.spoofing_alerts.extend(alerts)
                for a in alerts:
                    _logger.warning("SPOOFING suspected (PRN %s): %s", a.prn, a.detail)

        # --- one device dispatch tracks every channel for the whole block;
        # with pipelining the dispatch returns immediately and the block
        # processed below is the PREVIOUS one (this block's device compute
        # overlaps the previous block's host nav decode; with async_upload
        # the next block's samples cross meanwhile too).
        dispatch_input = upload_fut.result() if upload_fut is not None else track_input
        self.bank.dispatch_block(dispatch_input, block_start)
        # Read the NEXT block and start its upload now: it crosses to the
        # card while this block computes and the previous one is decoded.
        if self._async_upload and self._readahead is None and not self._readahead_eof:
            try:
                nxt = self._read_raw(block_ms)
            except NoMoreSamplesError:
                self._readahead_eof = True
            else:
                self._readahead = (*nxt, self._submit_upload(nxt[1]))
        if self.bank.pending_blocks > self._pipeline_depth:
            self._collect_into(report)
        self.block_reports.append(report)
        for fn in self._block_listeners:
            fn(self, report)
        return report

    def _collect_into(self, report: BlockReport) -> None:
        """Collect the oldest dispatched block and run all host-side
        navigation layers over it."""
        t0, n_ms, observations = self.bank.collect_block()
        report.observations = observations
        report.tracked_prns = [o.prn for o in observations]
        # Snapshot the still-healthy channels' (absolute Doppler, per-ms
        # prompt magnitude) for the deep-measurement cross-correlation veto
        # (track/deepmeas.py:xcorr_suspect): a strong live SV's C/A
        # sidelobes (-24 dB) can clear the noise gate in a dead PRN's
        # window whenever its Doppler aliases onto a 1 kHz code line.
        if any(p.coast_started is not None for p in self.pipelines.values()):
            live: dict[int, tuple[float, float]] = {}
            for obs in observations:
                pipe = self.pipelines.get(obs.prn)
                if (
                    pipe is None
                    or pipe.slot != obs.slot
                    or pipe.coast_started is not None
                    or bool(obs.lost)
                    or float(obs.quality[-1])
                    < self.config.tracking.coast_recovery_quality
                ):
                    continue
                mag = float(np.median(np.abs(np.asarray(obs.prompts))))
                live[obs.prn] = (
                    pipe.carrier_offset_hz + float(np.asarray(obs.dopplers)[-1]),
                    mag,
                )
            self._live_sig = live
        for obs in observations:
            pipe = self.pipelines.get(obs.prn)
            if pipe is None or pipe.slot != obs.slot:
                continue  # dropped/reassigned after this block was dispatched
            self._process_channel(obs, t0, n_ms, report)
        if self._coast_raw:  # this block's raw IQ has been consumed
            t0_key = int(round(t0 * 1e3))
            for k in [k for k in self._coast_raw if k <= t0_key]:
                del self._coast_raw[k]
            self._coast_raw_dev = None

        # --- position fix attempt (reference: gypsum/receiver.py:137) at
        # the PROCESSED block's end (the world model's tick counters are
        # only advanced this far). Secondary band receivers sharing a world
        # model leave the attempt to the owner (attempt_fixes=False).
        if self._attempt_fixes:
            report.fix = self.world.attempt_position_fix(t0 + n_ms * 1e-3)

        if self.spoofing is not None:
            alerts = self.spoofing.observe_block(self.world, report)
            report.spoofing_alerts.extend(alerts)
            for a in alerts:
                _logger.warning("SPOOFING suspected (%s): %s", a.kind, a.detail)

    def _should_scan(self, now: float) -> bool:
        if not self.eligible_prns or not self.bank.free_slots:
            return False
        if self._last_scan_time is None:
            return True
        return now - self._last_scan_time >= self.config.acquisition.scan_period_s

    def _scan_candidates(self, now: float) -> set[int]:
        """Eligible PRNs minus those the almanac/ephemeris predicts below the
        horizon (warm start, solve/almanac.py). A PRN with no orbit data is
        always scanned; the mask only ever *skips* satellites we can place in
        the sky, so a stale prediction costs one scan period, not the SV."""
        mask = self.config.acquisition.horizon_mask_deg
        if mask is None or not self.eligible_prns:
            return set(self.eligible_prns)
        sky = self.world.predicted_sky(now)
        if not sky:
            return set(self.eligible_prns)
        skipped = {
            p for p in self.eligible_prns
            if p in sky and sky[p].elevation_deg < mask
        }
        if skipped:
            _logger.info(
                "scan skipping %d below-horizon SV(s): %s",
                len(skipped), sorted(skipped),
            )
        return self.eligible_prns - skipped

    def _acquire(self, block: np.ndarray, block_start: float, report: BlockReport) -> None:
        n_ms = self.config.acquisition.integration_period_ms
        if block.shape[0] < n_ms:
            return
        candidates = self._scan_candidates(block_start)
        if not candidates:
            return
        hits = self._agreed(
            lambda: self.acquisition.detect(block[:n_ms], eligible_prns=candidates))
        for hit in hits:
            if not self.bank.free_slots:
                break
            # FDMA channels: the engine reports the ABSOLUTE baseband
            # frequency; the tracker's Doppler state is offset-relative.
            offset = self._channel_offset_hz.get(hit.prn, 0.0)
            slot = self.bank.assign(
                prn=hit.prn,
                doppler_hz=hit.doppler_hz - offset,
                code_phase_samples=hit.code_phase_samples,
                carrier_phase_rad=hit.carrier_phase_rad,
                carrier_offset_hz=offset,
            )
            if self.band == "glonass_l2":
                # Measurement-only channel: tracks the shared SP code at the
                # L2 sub-band, never decodes; its block-end code delay is
                # the L2 half of the measured iono difference.
                self.pipelines[hit.prn] = _ChannelPipeline(
                    prn=hit.prn, slot=slot, integrator=None, decoder=None,
                    acquired_at=block_start, carrier_offset_hz=offset,
                )
            elif self.band == "glonass":
                self.pipelines[hit.prn] = _ChannelPipeline(
                    prn=hit.prn, slot=slot, integrator=None, decoder=None,
                    acquired_at=block_start, glonass=GlonassStringDecoder(),
                    carrier_offset_hz=offset,
                )
            elif hit.prn >= 100:
                from gypsum_tpu_torch.nav.sbas import SbasFrameDecoder

                self.pipelines[hit.prn] = _ChannelPipeline(
                    prn=hit.prn, slot=slot, integrator=None, decoder=None,
                    acquired_at=block_start, sbas=SbasFrameDecoder(hit.prn),
                )
            else:
                self.pipelines[hit.prn] = _ChannelPipeline(
                    prn=hit.prn,
                    slot=slot,
                    integrator=BitIntegrator(self.config.nav),
                    decoder=SubframeDecoder(self.config.nav),
                    acquired_at=block_start,
                )
            self.eligible_prns.discard(hit.prn)
            report.newly_acquired.append(hit)
            _logger.info(
                "acquired PRN %d: doppler %.1f Hz, code phase %d, strength %.1f",
                hit.prn, hit.doppler_hz, hit.code_phase_samples, hit.strength,
            )

    # --------------------------------------------------------- per channel

    def _process_channel(
        self, obs: ChannelObservation, block_start: float, block_ms: int, report: BlockReport
    ) -> None:
        pipe = self.pipelines[obs.prn]
        if pipe.coast_started is not None:  # any family coasts the same way
            self._process_coasting_channel(obs, block_start, block_ms, report, pipe)
            return
        if self.band == "glonass_l2":
            self._process_l2_channel(obs, block_start, block_ms, report, pipe)
            return
        if pipe.glonass is not None:
            self._process_glonass_channel(obs, block_start, block_ms, report, pipe)
            return
        if pipe.sbas is not None:
            self._process_sbas_channel(obs, block_start, block_ms, report, pipe)
            return
        lost = obs.lost
        subframe_edges: list[tuple[float, EmitSubframeEvent]] = []

        events = pipe.integrator.process_block(
            obs.pseudosymbol_signs, obs.start_times, obs.end_times
        )
        for event in events:
            if isinstance(event, EmitNavigationBitEvent):
                for dec_event in pipe.decoder.process_bit(event):
                    if isinstance(dec_event, EmitSubframeEvent):
                        subframe_edges.append(
                            (dec_event.trailing_edge_receiver_timestamp, dec_event)
                        )
                    elif isinstance(dec_event, CannotDetermineSubframePhaseEvent):
                        # reference: satellite_signal_processing_pipeline.py:142-147.
                        lost = True
            elif isinstance(event, (CannotDetermineBitPhaseEvent, LostBitCoherenceEvent)):
                lost = True

        # --- PRN-tick accounting around mid-block subframe resets; the
        # block-end code delay comes from the projected-median measurement
        # (rationale in _block_end_observables).
        cp_delay, doppler = self._block_end_observables(obs)
        from gypsum_tpu_torch.obs.cn0 import cn0_m2m4_dbhz

        # Once-per-block observables (carrier smoothing + C/N0 weighting +
        # the block's carrier-phase advance for the TDCP velocity solve).
        adv = self._block_phase_advance(obs)
        self.world.handle_channel_block(
            obs.prn, cp_delay, doppler, block_ms,
            cn0_dbhz=cn0_m2m4_dbhz(obs.prompts),
            phase_advance_cycles=adv,
        )
        consumed = 0
        for t_edge, sf_event in sorted(subframe_edges, key=lambda x: x[0]):
            k_done = int(np.floor((t_edge - block_start) / 1e-3))  # chunks completed
            k_done = max(0, min(k_done, block_ms))
            if k_done > consumed:
                self.world.handle_prn_observed(
                    obs.prn, cp_delay, count=k_done - consumed, doppler_hz=doppler
                )
                consumed = k_done
            self.world.handle_subframe_emitted(obs.prn, sf_event)
            self.subframe_count += 1
            report.subframes.append((obs.prn, sf_event))
        if block_ms > consumed:
            self.world.handle_prn_observed(
                obs.prn, cp_delay, count=block_ms - consumed, doppler_hz=doppler
            )

        if not lost and self.world.seed_time_base_from_geometry(
            obs.prn, block_start + block_ms * 1e-3
        ):
            report.reseeded_prns.append(obs.prn)

        # Anchor for a future vector coast: the last block-end observables
        # measured while the channel was clearly healthy.
        if not lost and float(obs.quality[-1]) >= self.config.tracking.rescue_quality_threshold:
            pipe.last_good = (block_start + block_ms * 1e-3, cp_delay, doppler)

        if lost:
            if self._enter_coast(obs, pipe, block_start + block_ms * 1e-3):
                report.coasting_prns.append(obs.prn)
            else:
                self._drop_satellite(obs.prn, report)
        elif self.bank.maybe_rescue(obs, block_start + block_ms * 1e-3):
            # Marginal-health rescue (reference: gypsum/tracker.py:380-387):
            # Doppler corrected in place; the decode pipeline keeps its bit/
            # subframe phase and resynchronizes through normal UNKNOWN-bit
            # handling while the PLL resettles.
            report.rescued_prns.append(obs.prn)
            _logger.info(
                "rescued marginal PRN %d in place (quality %.2f, attempt %d)",
                obs.prn, float(obs.quality[-1]), self.bank.rescue_counts[obs.slot],
            )

    # ------------------------------------------------------- observables

    def _block_phase_advance(self, obs: ChannelObservation) -> float | None:
        """The channel's NCO carrier-phase advance over this block (cycles),
        for the TDCP velocity solve (solve/velocity.py:solve_tdcp).

        Same exact-reconstruction math as RTK's CarrierPhaseLog.ingest
        (solve/rtk.py): replay the per-ms update law in f64 to count whole
        turns, pin each sample back to the kernel's own wrapped value. The
        NCO runs continuously WITHIN a block by construction, so within-block
        validity only needs the loop locked throughout (pull-in phase noise
        would corrupt the measurement, and so would the different kp)."""
        locked = np.asarray(obs.locked, bool)
        if not locked.all():
            return None
        cfg = self.config.tracking
        t_ms = self.samples_per_prn / self.sample_rate
        kp = 4.0 * cfg.pll_damping_factor * cfg.pll_bandwidth_locked_hz * t_ms
        th = np.asarray(obs.carrier_phases, np.float64)
        fd = np.asarray(obs.dopplers, np.float64)
        pe = np.asarray(obs.pll_errors, np.float64)
        two_pi = 2.0 * np.pi
        dth = two_pi * fd * t_ms + kp * pe
        acc = th[0] + np.concatenate(([0.0], np.cumsum(dth[:-1])))
        pinned = th + two_pi * np.round((acc - th) / two_pi)
        if np.max(np.abs(pinned - acc)) > 1.0:  # replay diverged: reject
            return None
        return float((pinned[-1] + dth[-1] - pinned[0]) / two_pi)

    def _block_end_observables(
        self, obs: ChannelObservation, carrier_hz: float | None = None
    ) -> tuple[float, float]:
        """Block-end (code-phase delay s, carrier Doppler Hz) for pseudoranges.

        The sub-sample *measured* code phase feeds pseudoranges (1 sample of
        quantization is ~147 m of range at 2.046 Msps). Per-ms measurements
        are independent and unbiased (sigma ~0.03 samples), so project each
        onto the block end along the DETERMINISTIC code-Doppler drift and
        take the median of the last ~250: pseudorange noise drops ~sqrt(N)
        (a single final-millisecond reading was the receiver's dominant
        error at ~2-4 m; referencing against the loop cp instead would
        import the DLL's random walk, sigma ~0.2 samples)."""
        from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ

        spp = float(self.samples_per_prn)
        cm = np.asarray(obs.code_phases_measured, dtype=np.float64)
        f_car = carrier_hz or GPS_L1_FREQUENCY_HZ
        steps = (spp / f_car) * np.asarray(obs.dopplers, np.float64)
        # suffix[t] = sum(steps[t : -1]) — the drift between ms t and the
        # block's final millisecond (cp advances by -steps_t per ms).
        suffix = np.concatenate([np.cumsum(steps[:-1][::-1])[::-1], [0.0]])
        pred_end = cm - suffix
        n_avg = min(len(pred_end), max(1, self.config.solver.pseudorange_projection_ms))
        w = pred_end[-n_avg:]
        # Unwrap each prediction to the final reading's neighborhood, then
        # median (robust to the occasional adjacent-lag argmax outlier).
        w = (w - cm[-1] + spp / 2.0) % spp - spp / 2.0
        cp_block_end = (cm[-1] + float(np.median(w))) % spp
        return cp_block_end / self.sample_rate, float(obs.dopplers[-1])

    def _drop_satellite(self, prn: int, report: BlockReport) -> None:
        """reference: gypsum/receiver.py:259-267."""
        pipe = self.pipelines.pop(prn)
        self.bank.release(pipe.slot)
        self.world.handle_lost_satellite_lock(prn)
        self.eligible_prns.add(prn)
        report.dropped_prns.append(prn)
        _logger.info("dropped PRN %d (lost lock); returned to acquisition pool", prn)


class _Upload:
    """A block's samples on their way to the device."""

    def __init__(self, tensor: torch.Tensor, done, pinned: torch.Tensor | None = None) -> None:
        self._tensor = tensor
        self._done = done
        self._pinned = pinned

    def result(self) -> torch.Tensor:
        if self._done is not None:
            torch.cuda.current_stream(self._tensor.device).wait_event(self._done)
            # The tensor was made on the side stream: tell the allocator it
            # is now used on the current one.
            self._tensor.record_stream(torch.cuda.current_stream(self._tensor.device))
        return self._tensor


# Public API re-export (dualband imports Receiver from this module, so the
# import must come after the class definition).
from gypsum_tpu_torch.runtime.dualband import DualBandReceiver  # noqa: E402,F401
