"""Multi-band composition: several Receivers, one navigation solution.

Copy of gypsum_tpu/runtime/dualband.py with ``device=`` threaded through
to every band's Receiver. ``DualBandReceiver`` is importable from
gypsum_tpu_torch.runtime.receiver, which stays the public API.
"""

from __future__ import annotations

import torch

from gypsum_tpu_torch.core.config import ReceiverConfig
from gypsum_tpu_torch.core.events import NoMoreSamplesError
from gypsum_tpu_torch.io.sources import SampleSource
from gypsum_tpu_torch.runtime.pipeline import BlockReport
from gypsum_tpu_torch.solve.world import WorldModel


class DualBandReceiver:
    """Two front ends, one navigation solution: a GPS L1 C/A receiver and a
    GLONASS L1OF receiver stepping in lockstep over time-aligned captures,
    feeding a SHARED WorldModel whose dual-constellation solve estimates the
    inter-system clock bias (solve/world.py:_compute_position_dual).

    The reference is single-band single-constellation by construction; real
    dual-band hardware has two tuners on one clock, which is exactly the
    model here (both streams' sample timestamps share the receiver's
    timeline). Block cadence is in milliseconds, so the bands stay in step
    at different sample rates as long as their block_size_ms agree.
    """

    def __init__(
        self,
        gps_source: SampleSource | None,
        glonass_source: SampleSource,
        config: ReceiverConfig | None = None,
        glonass_config: ReceiverConfig | None = None,
        eligible_prns: list[int] | None = None,
        glonass_l2_source: SampleSource | None = None,
        glonass_l2_config: ReceiverConfig | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``gps_source`` may be None for a GLONASS-only receiver pairing
        L1OF with an L2OF band (``glonass_l2_source``): the GLONASS band
        then owns the fix attempt. With three sources this is a tri-band
        receiver (GPS L1 + GLONASS L1OF + GLONASS L2OF) — the L2 band is
        measurement-only, feeding the dual-frequency iono difference.

        ``device``: where every band acquires and tracks ("cuda" by
        default; raises when no card is present, pass "cpu" for the CPU)."""
        # runtime/receiver.py re-exports this class: import it here, so
        # that either module may be imported first.
        from gypsum_tpu_torch.runtime.receiver import Receiver

        self.config = config or ReceiverConfig()
        self.world = WorldModel(self.config.solver)
        # Contributing bands step first each block; the fix owner (GPS when
        # present, else GLONASS L1) steps LAST so its fix attempt sees every
        # band's ticks for the epoch — see step_block().
        self.glonass_l2 = (
            Receiver(
                glonass_l2_source, glonass_l2_config or glonass_config or config,
                band="glonass_l2", world=self.world, attempt_fixes=False,
                device=device,
            )
            if glonass_l2_source is not None
            else None
        )
        self.glonass = Receiver(
            glonass_source, glonass_config or config, band="glonass",
            world=self.world, attempt_fixes=gps_source is None, device=device,
        )
        self.gps = (
            Receiver(
                gps_source, config, eligible_prns=eligible_prns, world=self.world,
                device=device,
            )
            if gps_source is not None
            else None
        )
        self._owner = self.gps if self.gps is not None else self.glonass
        self._bands = [
            r for r in (self.glonass_l2, self.glonass, self.gps) if r is not None
        ]
        if len({r.config.tracking.block_size_ms for r in self._bands}) != 1:
            raise ValueError("all bands must use the same block_size_ms")

    def step_block(self) -> BlockReport:
        """One block of every band; the returned report is the fix owner's
        with the contributing bands' strings/tracked sets merged in."""
        reports = [band.step_block() for band in self._bands]
        report = reports[-1]  # the owner steps last
        for other in reports[:-1]:
            report.glonass_strings.extend(other.glonass_strings)
            report.tracked_prns.extend(other.tracked_prns)
        return report

    def run(
        self, max_seconds: float | None = None, until_fix: bool = False
    ) -> list[BlockReport]:
        start = self._owner.stream_position_s
        while True:
            if (
                max_seconds is not None
                and self._owner.stream_position_s - start >= max_seconds
            ):
                break
            try:
                report = self.step_block()
            except NoMoreSamplesError:
                break
            if until_fix and report.fix is not None:
                break
        for band in self._bands:
            while band.bank.pending_blocks:
                band._drain_one()
        return self._owner.block_reports
