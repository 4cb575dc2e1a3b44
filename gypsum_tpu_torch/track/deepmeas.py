"""Deep-integration ranging on coasting channels: measure, don't just predict.

Torch port of gypsum_tpu/track/deepmeas.py. The vector-coast tier
(runtime/coast.py) drives a blocked channel's NCOs open-loop from predicted
geometry — good enough to resume instantly when the signal returns, but
blind while it is gone: the prediction drifts with receiver oscillator
error (~0.04 samples/s at a 2e-8 TCXO) and the satellite is excluded from
fixes the whole time. The reference has no counterpart at all — below the
1 kHz loops' threshold it can only drop and reacquire
(reference: gypsum/receiver.py:248-267).

This module closes the loop the way a deep-integration (ultra-tightly
coupled) receiver does: each block, the raw IQ of the block is
re-correlated against the channel's replica in a NARROW window around the
prediction — tens of coherent 10 ms groups accumulated non-coherently, the
same integration structure as acquire/deep.py but over (2K+1) lags x a few
Doppler bins instead of the full search grid. Far below the tracking loops'
lock threshold this still yields a sub-sample code-phase and sub-Hz Doppler
MEASUREMENT:

- the coast prediction is re-anchored on it, and
- the satellite keeps feeding genuine pseudoranges to the fix
  (solve/world.py admits deep-measured coasting SVs when fewer than four
  healthy channels remain).

Device shape: the per-group coherent sums cost one Doppler wipeoff + reduce
([C, G, L]), and all (group, Doppler, lag) correlations evaluate as ONE
complex64 einsum against the [G, K, L] window matrix — a plain product that
the JAX package, too, leaves outside any Pallas kernel. It stays complex64
with TF32 off (``core/device.py``): the path integrates a signal ~30 dB
below the noise. Code-Doppler drift over the block is compensated by
per-group integer rolls (computed on the host from the prediction), and the
sub-sample rounding residuals of those rolls are removed from the final
vertex estimate (``mean_frac``). The host tail (edge rules, vertex
interpolation, phase-slope residual) is the JAX package's, in numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from gypsum_tpu_torch.core.config import TrackingConfig
from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.ops.correlate import doppler_wipeoff
from gypsum_tpu_torch.signal.prn import replica_table


#: Worst-case C/A cross-correlation magnitude relative to the autocorrelation
#: peak (Gold-code bound 65/1023 ~ -23.9 dB at aligned relative Doppler).
CA_XCORR_PEAK = 65.0 / 1023.0


@dataclass
class DeepCoastMeasurement:
    """One block's deep-integration measurement of a coasting channel."""

    detected: bool
    strength: float  # normalized peak (vs the far-lag noise floor)
    cp_error_samples: float  # measured - predicted code phase (samples)
    doppler_hz: float  # measured carrier Doppler (static offset excluded)
    groups: int  # non-coherent groups integrated
    peak_abs: float = 0.0  # non-coherent peak, absolute units (sum of G |coh|)
    floor_abs: float = 0.0  # far-lag noise floor in the same units


def xcorr_suspect(
    measured_abs_hz: float,
    peak_abs: float,
    n_groups: int,
    coherent_ms: int,
    live_channels: list[tuple[float, float]],  # [(abs Doppler Hz, per-ms prompt mag)]
    tol_hz: float,
    margin: float,
) -> bool:
    """True when a detection is explainable as C/A CROSS-correlation from a
    still-tracked strong channel rather than the coasting PRN's own signal.

    The C/A spectrum is a 1 kHz line comb (1 ms code period), so a strong
    live SV leaks into another PRN's correlator whenever the Doppler
    difference is near a multiple of 1 kHz — at up to ``CA_XCORR_PEAK`` of
    the live SV's own prompt level, which at deep-integration sensitivities
    is far above the noise gate. The veto fires when the measured absolute
    Doppler folds to within ``tol_hz`` of a live channel's AND the absolute
    peak is not more than ``margin`` x that channel's worst-case sidelobe
    (a genuinely strong faded signal exceeds the bound and passes).

    ``live_channels`` carries per-ms prompt magnitudes (~amplitude x L), the
    same units as one coherent millisecond of ``peak_abs``; a fully aligned
    sidelobe integrates to mag x coherent_ms x n_groups x CA_XCORR_PEAK.
    """
    for f_live, mag in live_channels:
        folded = (measured_abs_hz - f_live + 500.0) % 1000.0 - 500.0
        bound = float(mag) * coherent_ms * n_groups * CA_XCORR_PEAK
        if abs(folded) <= tol_hz and peak_abs <= margin * bound:
            return True
    return False


def rotate_f64(samples: torch.Tensor, offset_hz: float, sample_rate: float) -> torch.Tensor:
    """``samples`` (any shape, complex64, flattened in time order) times
    e^{-j 2 pi offset t} with the phase in float64, back to complex64: the
    static FDMA offset wipe, kept out of float32 (at ~4e6 cycles a float32
    phase is quantized to ~0.25 cycle)."""
    n_total = samples.numel()
    t = torch.arange(n_total, dtype=torch.float64, device=samples.device) / sample_rate
    phase = (-2.0 * math.pi * float(offset_hz)) * t
    rot = torch.polar(torch.ones_like(phase), phase)
    return (samples.reshape(-1).to(torch.complex128) * rot).to(torch.complex64).reshape(
        samples.shape
    )


class DeepCoastMeasurer:
    """Narrow grouped coherent x non-coherent correlator around a coast
    prediction, on ``device``. One instance per receiver band; the per-block
    programs are cached per geometry (G groups actually present in the
    block), as the JAX class caches its jitted programs."""

    def __init__(
        self,
        sample_rate: float,
        samples_per_prn: int,
        prns: tuple[int, ...],
        config: TrackingConfig,
        device: str | torch.device = "cuda",
    ) -> None:
        self.config = config
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.samples_per_prn = int(samples_per_prn)
        self.prns = tuple(prns)
        self._prn_row = {p: i for i, p in enumerate(self.prns)}
        reps = replica_table(self.samples_per_prn, self.prns)  # [N, L]
        self._replicas_tiled = torch.from_numpy(
            np.concatenate([reps, reps], axis=1).astype(np.float32)
        ).to(self.device)  # [N, 2L]
        self._programs: dict[int, object] = {}
        self.calls = 0  # measurements that reached the device
        c = int(config.coast_meas_doppler_bins)
        if c < 1 or c % 2 == 0:
            raise ValueError(f"coast_meas_doppler_bins must be odd >= 1, got {c}")

    # ------------------------------------------------------------- device

    def _program(self, n_groups: int):
        """[G*Nc, L] complex64 x [2L] replica x [C] dopplers x [G] rolls
        -> [G, C, Ktot] complex64 per-group correlations (signal lags
        0..2K, then noise lags at +L/2)."""
        fn = self._programs.get(n_groups)
        if fn is not None:
            return fn
        cfg = self.config
        nc = int(cfg.coast_meas_coherent_ms)
        k_half = int(cfg.coast_meas_lag_halfwidth)
        kn_half = max(1, int(cfg.coast_meas_noise_lags) // 2)
        length = self.samples_per_prn
        fs = self.sample_rate
        dev = self.device
        lag_sig = torch.arange(-k_half, k_half + 1, device=dev)
        lag_noise = torch.arange(-kn_half, kn_half + 1, device=dev)
        l_idx = torch.arange(length, device=dev)

        def program(x, rep_tiled, dopplers, cp_rolls):
            wiped = doppler_wipeoff(x, dopplers, fs)  # [C, G*Nc, L]
            coh = wiped.reshape(wiped.shape[0], n_groups, nc, length).sum(
                dim=2
            )  # [C, G, L] coherent within-group sums (one code period per ms,
            # so summing chunks before correlating is exact)
            # Each group's window rows: the replica rolled by (cp + k), as
            # ops/correlate.py:rolled_lag_window, for the signal lags around
            # cp and the noise lags around cp + L/2.
            cp = cp_rolls[:, None]  # [G, 1]
            starts = torch.cat([
                torch.remainder(length - cp - lag_sig[None, :], length),
                torch.remainder(length - torch.remainder(cp + length // 2, length)
                                - lag_noise[None, :], length),
            ], dim=1)  # [G, Ktot]
            win = rep_tiled[starts[:, :, None] + l_idx[None, None, :]]  # [G, Ktot, L]
            return torch.einsum("cgl,gkl->gck", coh, win.to(torch.complex64))

        self._programs[n_groups] = program
        return program

    # --------------------------------------------------------------- host

    def measure(
        self,
        samples,  # [n_ms * L] or [n_ms, L] complex64 raw block IQ: numpy or a tensor
        prn: int,
        pred_cp0_samples: float,  # predicted prompt code phase at block start
        drift_samples: float,  # predicted code-phase drift over the block
        pred_doppler_hz: float,  # predicted carrier Doppler (block center)
        static_offset_hz: float = 0.0,  # FDMA sub-band offset, wiped in f64
    ) -> DeepCoastMeasurement | None:
        """One block's measurement; None when the block is too short to form
        at least ``coast_meas_min_groups`` coherent groups.

        ``samples`` may already lie on the device (the receiver uploads a
        retained block once for all its coasting channels). A numpy block is
        uploaded here.

        ``static_offset_hz`` (GLONASS FDMA sub-band offsets, up to ~±4 MHz)
        is removed HERE in float64 (``rotate_f64``, on the device) before the
        float32 wipeoff, which accumulates phase per chunk and at 4e6 cycles
        would put ~45° of per-ms phase jitter on exactly the weak-signal path
        that needs coherence. Only the kHz-scale Doppler grid reaches the
        float32 wipeoff, and the returned ``doppler_hz`` excludes the
        offset."""
        cfg = self.config
        length = self.samples_per_prn
        nc = int(cfg.coast_meas_coherent_ms)
        x = torch.as_tensor(samples).to(self.device, torch.complex64)
        if x.dim() == 1:
            n_ms = x.shape[0] // length
            x = x[: n_ms * length].reshape(n_ms, length)
        n_ms = x.shape[0]
        n_groups = n_ms // nc
        if n_groups < int(cfg.coast_meas_min_groups):
            return None
        if static_offset_hz != 0.0:
            x = rotate_f64(x, static_offset_hz, self.sample_rate)
        used = x[: n_groups * nc]

        # Per-group predicted prompt code phase (linear in time: SV range
        # curvature over a block is < 1e-3 samples) and its integer rolls.
        drift_per_ms = drift_samples / max(n_ms, 1)
        g_center_ms = np.arange(n_groups) * nc + (nc - 1) / 2.0
        cp_pred_g = pred_cp0_samples + drift_per_ms * g_center_ms  # [G]
        cp_rolls = np.round(cp_pred_g).astype(np.int64)
        mean_frac = float(np.mean(cp_pred_g - cp_rolls))
        cp_rolls = np.mod(cp_rolls, length)

        c_bins = int(cfg.coast_meas_doppler_bins)
        step = float(cfg.coast_meas_doppler_step_hz)
        dopplers = (
            pred_doppler_hz + step * (np.arange(c_bins) - (c_bins - 1) / 2.0)
        ).astype(np.float32)

        fn = self._program(n_groups)
        row = self._prn_row[prn]
        self.calls += 1
        y = fn(
            used,
            self._replicas_tiled[row],
            torch.from_numpy(dopplers).to(self.device),
            torch.from_numpy(cp_rolls).to(self.device),
        ).cpu().numpy()  # [G, C, Ktot]

        k_half = int(cfg.coast_meas_lag_halfwidth)
        k2 = 2 * k_half + 1
        sig = np.abs(y[:, :, :k2]).sum(axis=0)  # [C, K2]
        floor = np.abs(y[:, :, k2:]).sum(axis=0).mean(axis=-1)  # [C]
        norm = sig / np.maximum(floor[:, None], 1e-12)
        c_star, k_star = np.unravel_index(np.argmax(norm), norm.shape)
        strength = float(norm[c_star, k_star])

        peak_abs = float(sig[c_star, k_star])
        floor_abs = float(floor[c_star])
        threshold = 1.0 + float(cfg.coast_meas_threshold_k) / np.sqrt(n_groups)
        # An edge argmax cannot be vertex-interpolated and usually means the
        # true peak sits outside the window — treat as no detection. The
        # Doppler axis gets the same rule: the squared phase-slope residual
        # is only unambiguous to ±1/(4 t_group) (±25 Hz at 10 ms groups), so
        # an edge-bin Doppler would alias and re-anchor the coast to a wrong
        # frequency.
        detected = bool(
            strength >= threshold
            and 0 < k_star < k2 - 1
            and (c_bins == 1 or 0 < c_star < c_bins - 1)
        )
        if not detected:
            return DeepCoastMeasurement(
                detected=False,
                strength=strength,
                cp_error_samples=0.0,
                doppler_hz=float(pred_doppler_hz),
                groups=n_groups,
                peak_abs=peak_abs,
                floor_abs=floor_abs,
            )

        # Sub-sample vertex (same triangle interpolation as the tracker's
        # measured code phase, track/loop.py): R = accumulated |corr|.
        r0 = sig[c_star, k_star]
        rp = sig[c_star, k_star + 1]
        rm = sig[c_star, k_star - 1]
        frac = float(
            np.clip((rp - rm) / (2.0 * (r0 - min(rp, rm)) + 1e-12), -0.5, 0.5)
        )
        cp_error = (k_star - k_half) + frac - mean_frac

        # Doppler residual from the squared group-to-group phase slope
        # (squaring removes 50 bps data-bit sign flips between groups —
        # same estimator as acquire/deep.py:_refine).
        yw = y[:, c_star, k_star]
        q = yw[1:] * np.conj(yw[:-1])
        r = np.sum(q * q)
        t_group = nc * 1e-3
        residual = float(np.angle(r)) / (2.0 * 2.0 * np.pi * t_group)
        doppler = float(dopplers[c_star]) + residual

        return DeepCoastMeasurement(
            detected=True,
            strength=strength,
            cp_error_samples=float(cp_error),
            doppler_hz=doppler,
            groups=n_groups,
            peak_abs=peak_abs,
            floor_abs=floor_abs,
        )
