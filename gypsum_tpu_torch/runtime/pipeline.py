"""Per-channel host-side decode state and the per-block report record.

Split out of runtime/receiver.py in round 5 (the module had accreted to
1,300 lines — the same god-module failure mode that bit solve/world.py in
round 3). Both names remain importable from gypsum_tpu_torch.runtime.receiver,
which stays the public API.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from gypsum_tpu_torch.acquire.engine import AcquisitionResult
from gypsum_tpu_torch.nav.bits import BitIntegrator
from gypsum_tpu_torch.nav.frames import EmitSubframeEvent, SubframeDecoder
from gypsum_tpu_torch.solve.world import ReceiverSolution
from gypsum_tpu_torch.track.loop import ChannelObservation


@dataclass
class _ChannelPipeline:
    """Host-side per-satellite decode state (analogue of the reference's
    GpsSatelliteSignalProcessingPipeline,
    gypsum/satellite_signal_processing_pipeline.py:35-102).

    GPS channels carry the bit integrator + subframe decoder; SBAS GEO
    channels (PRNs 120-138) carry the DO-229 frame decoder instead — the
    tracking slot underneath is identical."""

    prn: int
    slot: int
    integrator: BitIntegrator | None
    decoder: SubframeDecoder | None
    acquired_at: float = 0.0
    sbas: "object | None" = None  # nav.sbas.SbasFrameDecoder
    # GLONASS channels (ids 201-214) carry the string decoder instead; the
    # tracking slot underneath is identical (1 ms code period either way).
    glonass: "object | None" = None  # nav.glonass.GlonassStringDecoder
    carrier_offset_hz: float = 0.0  # FDMA sub-band offset of this channel
    # Vector-coast state (TrackingConfig.coast_*): last healthy block-end
    # observables (t, code_phase_delay_s, doppler_hz) anchoring the coast
    # prediction; when coasting, the entry time and the geometry anchor
    # (t0, delay0_s, doppler0_hz, range0_m, range_rate0_m_s).
    last_good: tuple | None = None
    coast_started: float | None = None
    coast_anchor: tuple | None = None
    # Last successful deep-integration measurement time (track/deepmeas.py):
    # refreshes the coast_max_s deadline — the signal is present, just weak.
    coast_measured_at: float | None = None
    # Multi-block confirmation of deep detections
    # (TrackingConfig.coast_meas_confirm_blocks): Doppler of the last
    # detection and the length of the current consistent streak. A detection
    # acts (re-anchor / fix admission / deadline refresh) only once the
    # streak reaches the configured length — sidelobe and noise artifacts do
    # not repeat coherently block over block.
    deep_candidate_hz: float | None = None
    deep_streak: int = 0


@dataclass
class BlockReport:
    """What happened during one block iteration.

    In pipelined mode (pipeline_tracking / the TPU default) a report is
    labeled with the block DISPATCHED this iteration while its
    observations/subframes/fix come from the previously dispatched block
    (collected one iteration later); totals across a run are exact, and the
    final in-flight block is drained into its own correctly-labeled report.
    Unpipelined mode collects the same block it dispatches."""

    block_start: float
    block_end: float
    tracked_prns: list[int] = field(default_factory=list)
    newly_acquired: list[AcquisitionResult] = field(default_factory=list)
    dropped_prns: list[int] = field(default_factory=list)
    rescued_prns: list[int] = field(default_factory=list)
    # PRNs whose millisecond time base was seeded from geometry this block
    # (solve/world.py:seed_time_base_from_geometry) — ranging immediately
    # after (re)acquisition instead of waiting for a subframe.
    reseeded_prns: list[int] = field(default_factory=list)
    # PRNs held open-loop this block by the vector-coast tier, and PRNs
    # whose signal returned this block (coast exited, decode restarted).
    coasting_prns: list[int] = field(default_factory=list)
    coast_recovered_prns: list[int] = field(default_factory=list)
    # Coasting PRNs whose observables this block came from a deep-integration
    # MEASUREMENT of the raw IQ (track/deepmeas.py) instead of the open-loop
    # prediction — these keep feeding the fix through the fade.
    deep_measured_prns: list[int] = field(default_factory=list)
    subframes: list[tuple[int, EmitSubframeEvent]] = field(default_factory=list)
    sbas_blocks: list = field(default_factory=list)  # [(prn, nav.sbas.SbasBlock)]
    glonass_strings: list = field(default_factory=list)  # [(id, GlonassStringEvent)]
    fix: ReceiverSolution | None = None
    observations: list[ChannelObservation] = field(default_factory=list)
    # Alerts raised by the spoofing monitors this block (solve/spoofing.py).
    spoofing_alerts: list = field(default_factory=list)
