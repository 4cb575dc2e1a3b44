"""Spoofing detection: vestigial-peak, clock, position and C/N0 monitors.

Beyond the reference (which will happily track and fix on whatever signal
is strongest): a GPS spoofer — a meacon replaying the live sky with a
delay, or a signal generator synthesizing a coherent false constellation —
must coexist with the authentic signals while it captures the tracking
loops. That coexistence is detectable, and once the loops ARE captured the
lie shows up as dynamics the receiver's own state history rejects. Four
complementary monitors, standard practice in anti-spoofing literature
(Humphreys et al.'s drag-off experiments; DHS/DOT GPS testing guidance):

1. **Vestigial peak** (the strong evidence, while both signals are on air):
   for each TRACKED satellite, correlate a 10 ms snapshot against the
   replica with the region around the tracked code phase excluded; a second
   correlation peak above threshold means two transmitters are broadcasting
   the same PRN. Pure host numpy — a handful of 2048-point FFTs per scan —
   because the TPU path must not spend upload bandwidth on a watchdog.
2. **Clock innovation**: a spoofer pulling time shows up as receiver clock
   slide moving away from its own (robust-fitted) drift history by far more
   than the oscillator could.
3. **Position jump**: consecutive least-squares fixes separated by more
   than the receiver could have moved.
4. **C/N0 step**: a coordinated power step across channels when the spoofer
   raises its gain to capture the loops.

Every monitor emits ``SpoofingAlert``s; the receiver logs them, counts them
in ``BlockReport.spoofing_alerts``, and leaves response policy (ignore,
de-weight, re-acquire) to the operator — a wrong automatic response to a
false alarm is itself a denial of service.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from gypsum_tpu_torch.core.config import SpoofingConfig

_logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class SpoofingAlert:
    t: float  # stream time (s)
    kind: str  # "vestigial" | "clock" | "position" | "cn0"
    prn: int | None
    detail: str
    severity: float  # monitor-specific statistic (thresholded already)


def vestigial_peak(
    block_ms: np.ndarray,  # [M, L] complex64, >= ~10 ms
    prn: int,
    sample_rate: float,
    tracked_code_phase_samples: float,
    tracked_doppler_hz: float,
    exclude_chips: float = 2.0,
    doppler_offsets_hz: tuple[float, ...] = (-400.0, -200.0, 0.0, 200.0, 400.0),
) -> tuple[float, float, float, float]:
    """Best correlation peak for ``prn`` OUTSIDE the tracked peak's
    neighborhood: (strength, code_phase_samples, doppler_offset_hz,
    ratio_to_tracked).

    Strength is peak / mean-of-rest of the non-coherent per-ms profile (the
    same statistic as acquisition), computed with lags within
    ``exclude_chips`` of the tracked code phase removed;
    ``ratio_to_tracked`` is the second peak's height relative to the
    tracked peak's own. Both matter: a strong authentic signal's Gold-code
    correlation sidelobes (amplitude <= 65/1023 ~ -24 dB of its peak) can
    clear a floor-relative threshold on their own, but never approach the
    tracked peak's height — while a spoofer must, to have any chance of
    capturing the loops. Per-ms non-coherent summation keeps ~+/-200 Hz of
    Doppler tolerance per offset, so the scanned offsets cover the
    +/-500 Hz a capture-stage spoofer plausibly sits at relative to the
    authentic signal."""
    from gypsum_tpu_torch.signal.prn import sampled_replica

    m, length = block_ms.shape
    fs = sample_rate
    replica_fft_conj = np.conj(np.fft.fft(sampled_replica(prn, length)))
    t = np.arange(length) / fs

    samples_per_chip = length / 1023.0
    lag = np.arange(length, dtype=np.float64)
    d = np.abs((lag - tracked_code_phase_samples + length / 2) % length - length / 2)
    keep = d > exclude_chips * samples_per_chip

    best = (0.0, 0.0, 0.0)
    best_peak = 0.0
    tracked_peak = 1e-12
    for off in doppler_offsets_hz:
        f = tracked_doppler_hz + off
        wipe = np.exp(-2j * np.pi * f * t).astype(np.complex64)
        prof = np.zeros(length)
        for k in range(m):
            x = np.fft.fft(block_ms[k] * wipe)
            prof += np.abs(np.fft.ifft(x * replica_fft_conj))
        if off == 0.0:
            tracked_peak = max(float(prof[~keep].max()), 1e-12)
        masked = prof[keep]
        peak_idx = int(np.argmax(masked))
        peak = float(masked[peak_idx])
        mean_rest = float((masked.sum() - peak) / (len(masked) - 1))
        strength = peak / max(mean_rest, 1e-12)
        if strength > best[0]:
            cp = float(lag[keep][peak_idx])
            best = (strength, cp, off)
            best_peak = peak
    return (*best, best_peak / tracked_peak)


class SpoofingMonitor:
    """Stateful per-receiver spoofing watchdog; see module docstring."""

    def __init__(self, config: SpoofingConfig | None = None) -> None:
        self.config = config or SpoofingConfig()
        self.alerts: list[SpoofingAlert] = []
        self._cn0_ema: dict[int, float] = {}
        self._cn0_hot: dict[int, int] = {}  # consecutive blocks over threshold
        self._slide_hist: list[tuple[float, float]] = []  # (t, slide)
        self._last_fix: tuple[float, np.ndarray] | None = None
        self._last_scan_t: float | None = None
        self._fixed_once = False  # slide history datum is fix-corrected

    # -------------------------------------------------------- cheap checks

    def _finish(self, out: list[SpoofingAlert]) -> list[SpoofingAlert]:
        self.alerts.extend(out)
        return out

    def observe_block(self, world, report) -> list[SpoofingAlert]:
        """Per-block bookkeeping checks (C/N0 steps, clock innovation,
        position jumps). Cheap: a few scalars per channel."""
        out: list[SpoofingAlert] = []
        cfg = self.config
        t = report.block_end

        for obs in report.observations:
            rec = world._sats.get(obs.prn)
            if rec is None or rec.cn0_dbhz is None:
                continue
            ema = self._cn0_ema.get(obs.prn)
            if ema is not None and rec.cn0_dbhz - ema > cfg.cn0_jump_db:
                self._cn0_hot[obs.prn] = self._cn0_hot.get(obs.prn, 0) + 1
                if self._cn0_hot[obs.prn] == cfg.cn0_jump_blocks:
                    out.append(SpoofingAlert(
                        t, "cn0", obs.prn,
                        f"C/N0 stepped {rec.cn0_dbhz - ema:+.1f} dB over its "
                        f"EMA for {cfg.cn0_jump_blocks} blocks",
                        rec.cn0_dbhz - ema,
                    ))
            else:
                self._cn0_hot[obs.prn] = 0
                # Freeze the EMA while hot: a captured channel must not
                # teach the baseline its new power level in two blocks.
                self._cn0_ema[obs.prn] = (
                    rec.cn0_dbhz if ema is None
                    else (1 - cfg.cn0_ema_alpha) * ema + cfg.cn0_ema_alpha * rec.cn0_dbhz
                )

        if world.receiver_clock_slide is not None:
            # The slide's datum is only stable AFTER the first least-squares
            # fix: before it, every decoded subframe re-bases the slide by
            # its own satellite's transit time (ms-scale, and across BANDS
            # in a dual-constellation receiver), so pre-fix innovations say
            # nothing about spoofing. The monitor arms at the first fix.
            if not self._fixed_once:
                if report.fix is not None and report.fix.kind == "lsq":
                    self._fixed_once = True
                    self._slide_hist.clear()
                else:
                    return self._finish(out)
            self._slide_hist.append((t, world.receiver_clock_slide))
            del self._slide_hist[: -cfg.clock_history]
            if len(self._slide_hist) >= 6:
                ts = np.array([h[0] for h in self._slide_hist[:-1]])
                ss = np.array([h[1] for h in self._slide_hist[:-1]])
                drift, off = np.polyfit(ts - ts[0], ss, 1)
                pred = off + drift * (t - ts[0])
                innov = world.receiver_clock_slide - pred
                resid = ss - (off + drift * (ts - ts[0]))
                gate = max(cfg.clock_innovation_s, 6.0 * float(np.std(resid)))
                if abs(innov) > gate:
                    out.append(SpoofingAlert(
                        t, "clock", None,
                        f"clock slide jumped {innov*1e9:+.0f} ns off its "
                        f"drift history (gate {gate*1e9:.0f} ns)",
                        abs(innov) / gate,
                    ))

        fix = report.fix
        if fix is not None and fix.kind == "lsq":
            if self._last_fix is not None:
                t0, p0 = self._last_fix
                dt = max(fix.receiver_timestamp - t0, 1e-3)
                jump = float(np.linalg.norm(np.asarray(fix.ecef) - p0))
                allowed = cfg.position_jump_m + cfg.position_jump_speed_mps * dt
                if jump > allowed:
                    out.append(SpoofingAlert(
                        t, "position", None,
                        f"fix jumped {jump:.0f} m in {dt:.1f} s "
                        f"(allowed {allowed:.0f} m)",
                        jump / allowed,
                    ))
            self._last_fix = (fix.receiver_timestamp, np.asarray(fix.ecef))

        self.alerts.extend(out)
        return out

    # ----------------------------------------------------- vestigial scan

    def should_scan(self, now: float) -> bool:
        if self._last_scan_t is None:
            self._last_scan_t = now  # first block: channels not settled yet
            return False
        if now - self._last_scan_t >= self.config.scan_period_s:
            self._last_scan_t = now
            return True
        return False

    def vestigial_scan(
        self,
        block_ms: np.ndarray,  # [M, L] complex64 head of the current block
        sample_rate: float,
        tracked: dict[int, tuple[float, float]],  # prn -> (cp_samples, doppler)
        t: float,
    ) -> list[SpoofingAlert]:
        cfg = self.config
        out: list[SpoofingAlert] = []
        for prn, (cp, fd) in tracked.items():
            if prn >= 100:  # GEO data channels: GPS-family check only
                continue
            strength, cp2, doff, ratio = vestigial_peak(
                block_ms, prn, sample_rate, cp, fd,
                exclude_chips=cfg.exclude_chips,
            )
            if (strength > cfg.vestigial_threshold
                    and ratio > cfg.vestigial_min_ratio):
                out.append(SpoofingAlert(
                    t, "vestigial", prn,
                    f"second peak at code phase {cp2:.0f} (tracked {cp:.0f}), "
                    f"doppler {fd + doff:+.0f} Hz, strength {strength:.1f}, "
                    f"{ratio:.2f}x the tracked peak",
                    strength,
                ))
        self.alerts.extend(out)
        return out
