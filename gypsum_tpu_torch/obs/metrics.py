"""Receiver metrics: throughput, per-channel health, event counters.

The reference's only observability is INFO logging plus rolling deques
consumed by its matplotlib dashboard (SURVEY.md §5). Here metrics are a
first-class registry fed from block reports; the tracked headline is IQ
Msamples/s (the BASELINE.json metric), plus wall-clock realtime factor and
per-channel signal health. The registry renders to a dict for the dashboard
and to a one-line log summary.
"""

from __future__ import annotations

import time

import numpy as np
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class ChannelHealth:
    prn: int
    doppler_hz: float = 0.0
    quality: float = 0.0
    locked: bool = False
    code_phase: float = 0.0
    pseudosymbols: int = 0
    cn0_dbhz: float | None = None
    # Dual-frequency measured slant iono at the channel's own carrier
    # (meters) and the equivalent slant TEC (TECU, 1e16 el/m^2) —
    # GLONASS L1+L2 channels only (solve/world_multiconstellation.py).
    iono_measured_m: float | None = None
    stec_tecu: float | None = None


@dataclass
class ReceiverMetrics:
    """Attach with ``receiver.add_block_listener(metrics.on_block)``."""

    started_wall: float = field(default_factory=time.perf_counter)
    samples_processed: int = 0
    signal_seconds: float = 0.0
    blocks: int = 0
    subframe_count: int = 0
    fix_count: int = 0
    acquisitions: int = 0
    drops: int = 0
    rescues: int = 0
    # Spoofing alerts (solve/spoofing.py) by kind, and interference blocks
    # seen by a NotchingSampleSource front end (ops/interference.py).
    spoofing_alerts: dict = field(default_factory=lambda: defaultdict(int))
    interference_blocks: int = 0
    channels: dict = field(default_factory=dict)
    last_fix: dict | None = None

    _iono_decoded: bool = False

    def on_block(self, receiver, report) -> None:
        self._iono_decoded = receiver.world.iono_utc is not None
        block_samples = int(
            (report.block_end - report.block_start) * receiver.sample_rate
        )
        self.samples_processed += block_samples
        self.signal_seconds += report.block_end - report.block_start
        self.blocks += 1
        self.subframe_count = receiver.subframe_count
        self.acquisitions += len(report.newly_acquired)
        self.drops += len(report.dropped_prns)
        self.rescues += len(getattr(report, "rescued_prns", []))
        for alert in getattr(report, "spoofing_alerts", []):
            self.spoofing_alerts[alert.kind] += 1
        src = getattr(receiver, "source", None)
        if src is not None and hasattr(src, "interference_seconds"):
            self.interference_blocks = len(src.events)
        for obs in report.observations:
            iono_m = stec = None
            rec = receiver.world._sats.get(obs.prn)
            if rec is not None and rec.glonass is not None and rec.smoothed_delay_s is not None:
                iono_s = receiver.world.measured_iono_l1_s(
                    obs.prn, rec.smoothed_delay_s,
                    now=report.block_end,
                )
                if iono_s is not None:
                    from gypsum_tpu_torch.core.constants import (
                        SPEED_OF_LIGHT_M_PER_S as _C,
                    )

                    f1 = rec.glonass.carrier_frequency_hz
                    iono_m = iono_s * _C
                    # Slant TEC: I = 40.3 * TEC / f^2  ->  TEC[TECU] =
                    # I_m * f^2 / 40.3 / 1e16.
                    stec = iono_m * f1 * f1 / 40.3 / 1e16
            self.channels[obs.prn] = ChannelHealth(
                prn=obs.prn,
                doppler_hz=float(obs.dopplers[-1]),
                quality=float(obs.quality[-1]),
                locked=bool(obs.locked[-1]),
                code_phase=float(obs.code_phases[-1]),
                pseudosymbols=len(obs.pseudosymbol_signs),
                cn0_dbhz=rec.cn0_dbhz if rec is not None else None,
                iono_measured_m=iono_m,
                stec_tecu=stec,
            )
        for prn in report.dropped_prns:
            self.channels.pop(prn, None)
        if report.fix is not None:
            self.fix_count += 1
            self.last_fix = {
                "lat_deg": report.fix.lat_deg,
                "lon_deg": report.fix.lon_deg,
                "alt_m": report.fix.alt_m,
                "clock_bias_s": report.fix.clock_bias_s,
                "satellites": list(report.fix.satellites_used),
                "receiver_timestamp": report.fix.receiver_timestamp,
                "speed_mps": (
                    float(np.linalg.norm(report.fix.velocity_ecef_mps))
                    if report.fix.velocity_ecef_mps is not None
                    else None
                ),
                "clock_drift_s_per_s": report.fix.clock_drift_s_per_s,
                # "lsq" or "ekf" (coast below four satellites, solve/ekf.py)
                "kind": report.fix.kind,
                # Satellites whose iono was MEASURED (own dual-frequency
                # band or the mapped cross-constellation estimate),
                # prn -> slant L1 delay in meters.
                "iono_measured_m": (
                    {p: round(v, 2) for p, v in report.fix.iono_measured_m.items()}
                    if report.fix.iono_measured_m
                    else None
                ),
            }

    @property
    def wall_seconds(self) -> float:
        return time.perf_counter() - self.started_wall

    @property
    def msamples_per_sec(self) -> float:
        w = self.wall_seconds
        return self.samples_processed / w / 1e6 if w > 0 else 0.0

    @property
    def realtime_factor(self) -> float:
        w = self.wall_seconds
        return self.signal_seconds / w if w > 0 else 0.0

    def snapshot(self) -> dict:
        return {
            "signal_seconds": round(self.signal_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 3),
            "msamples_per_sec": round(self.msamples_per_sec, 3),
            "realtime_factor": round(self.realtime_factor, 3),
            "blocks": self.blocks,
            "subframes": self.subframe_count,
            "fixes": self.fix_count,
            "acquisitions": self.acquisitions,
            "drops": self.drops,
            "rescues": self.rescues,
            "spoofing_alerts": dict(self.spoofing_alerts),
            "interference_blocks": self.interference_blocks,
            # Atmospheric-correction state (solve/iono.py, solve/tropo.py):
            # whether subframe 4 page 18 has been decoded yet.
            "iono_utc_decoded": self._iono_decoded,
            "channels": {
                prn: {
                    "doppler_hz": round(c.doppler_hz, 1),
                    "quality": round(c.quality, 3),
                    "locked": c.locked,
                    "code_phase": round(c.code_phase, 2),
                    "cn0_dbhz": None if c.cn0_dbhz is None else round(c.cn0_dbhz, 1),
                    **(
                        {
                            "iono_measured_m": round(c.iono_measured_m, 2),
                            "stec_tecu": round(c.stec_tecu, 2),
                        }
                        if c.iono_measured_m is not None
                        else {}
                    ),
                }
                for prn, c in sorted(self.channels.items())
            },
            "last_fix": self.last_fix,
        }

    def summary_line(self) -> str:
        fix = ""
        if self.last_fix:
            fix = (f" fix=({self.last_fix['lat_deg']:.5f},"
                   f"{self.last_fix['lon_deg']:.5f})")
        return (
            f"t={self.signal_seconds:.0f}s {self.msamples_per_sec:.2f} Msps "
            f"({self.realtime_factor:.2f}x rt) tracking={sorted(self.channels)} "
            f"subframes={self.subframe_count} fixes={self.fix_count}{fix}"
        )
