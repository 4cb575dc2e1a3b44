"""Cold-start acquisition: the whole PRN family in one pass on the device.

Torch port of gypsum_tpu/acquire/engine.py. Reference behavior
(gypsum/acquisition.py): search each PRN over +/-7 kHz of Doppler and all
code phases using 10 ms of non-coherently integrated FFT correlation; accept
satellites whose normalized peak strength exceeds 3.0; report (Doppler, code
phase, carrier phase, strength).

Three stages, all PRNs at once:

1. Coarse: non-coherent 10 ms integration over a fixed +/-7 kHz / 500 Hz
   grid (``ops/correlate.py``: batched FFTs, or with ``correlator="matmul"``
   bf16 products against circulant replica tables); the flat argmax over
   [Doppler x code phase] gives the code phase and a Doppler bin, ties
   going to the lowest Doppler bin, then the lowest code phase. With
   ``use_pallas_peak_reduce`` the grid's row reduce goes through kernel K2
   (``ops/peak_reduce.py``) with the same tie order.
2. Fine: coherent 10 ms integration at the detected code phase over a
   +/-400 Hz / 25 Hz grid, with the wipeoff separated into per-satellite
   coarse terms and a shared fine-offset basis (one [S, L] x [L, F] product
   per millisecond).
3. Phase slope: the residual Doppler from the squared per-ms prompts
   (squaring cancels BPSK bit flips).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from gypsum_tpu_torch.core import aot
from gypsum_tpu_torch.core.config import AcquisitionConfig
from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.ops.correlate import (
    build_circulant_table,
    noncoherent_acquisition_sweep,
    noncoherent_acquisition_sweep_matmul,
    peak_strength,
    replica_fft_conj_table,
)
from gypsum_tpu_torch.ops.peak_reduce import PEAK_REDUCE_KERNEL, peak_reduce
from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS, replica_table


@dataclass(frozen=True)
class AcquisitionResult:
    """One satellite's acquisition estimate
    (reference: gypsum/acquisition.py:35-41)."""

    prn: int
    doppler_hz: float
    code_phase_samples: int
    carrier_phase_rad: float
    strength: float

    @property
    def detected(self) -> bool:  # convenience for callers holding a config
        return self.strength > AcquisitionConfig().detection_threshold


def _mod_cycles(cycles: torch.Tensor) -> torch.Tensor:
    """Reduce a phase expressed in cycles to [-0.5, 0.5] to keep f32 exact."""
    return cycles - torch.round(cycles)


def coarse_peak(noncoh: torch.Tensor, use_kernel: bool):
    """The coarse grid's peak per satellite: ([S] Doppler bin, [S] code
    phase, [S] normalized strength) from the [S, D, L] non-coherent power.

    Ties go to the lowest Doppler bin, then the lowest code phase, on both
    routes: the flat argmax over [D x L] (torch.argmax returns the first
    maximum), or, with ``use_kernel``, kernel K2's per-(sat, Doppler) row
    reduce (first-index argmax) followed by a first-index argmax over the
    [S, D] row maxima."""
    s_count, d_count, length = noncoh.shape
    sats = torch.arange(s_count, device=noncoh.device)
    if use_kernel:
        mx, arg, sm = peak_reduce(noncoh.reshape(s_count * d_count, length))
        mx = mx.reshape(s_count, d_count)
        best_d_idx = torch.argmax(mx, dim=-1)  # [S]
        rows = sats * d_count + best_d_idx
        code_phase = arg[rows].to(torch.int64)  # [S]
        peak = mx[sats, best_d_idx]
        mean_rest = (sm[rows] - peak) / (length - 1)
        return best_d_idx, code_phase, peak / mean_rest
    flat_idx = torch.argmax(noncoh.reshape(s_count, -1), dim=-1)  # [S]
    best_d_idx = flat_idx // length
    code_phase = flat_idx % length  # [S]
    return best_d_idx, code_phase, peak_strength(noncoh[sats, best_d_idx])


def _phasor(freq_x_time: torch.Tensor) -> torch.Tensor:
    arg = -2 * math.pi * freq_x_time
    return torch.complex(torch.cos(arg), torch.sin(arg))


class AcquisitionEngine(nn.Module):
    """Searches a whole PRN family (default: the 32 GPS SVs; any registered
    C/A-family set, e.g. GPS+SBAS, via ``prns``) in one pass.

    ``center_offsets_hz``: per-row FDMA sub-band centers (aligned with
    ``prns``) for frequency-division families: GLONASS channels search
    +/-doppler_max around k * 562.5 kHz (L2OF: k * 437.5 kHz) instead of
    around 0. All rows must share ONE code (true of GLONASS); the whole
    [channel x Doppler] grid then flattens into a single-code sweep over a
    concatenated Doppler list. Reported ``doppler_hz`` stays the ABSOLUTE
    baseband frequency (offset + Doppler); callers subtract the channel
    center when seeding a tracker's offset-relative Doppler.

    The replica FFT table (or, with ``correlator="matmul"``, the bf16
    circulant tables, built once here on ``device``), the tiled replicas and
    the Doppler grids are registered buffers on ``device``. ``libraries``
    names the kernels the sweep launches on a CUDA device (K2's source with
    ``use_pallas_peak_reduce``); construction starts their preload
    (``core/aot.py``).
    """

    def __init__(
        self,
        sample_rate: float,
        samples_per_prn: int,
        config: AcquisitionConfig | None = None,
        prns: tuple[int, ...] = ALL_PRN_IDS,
        center_offsets_hz: "tuple[float, ...] | None" = None,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__()
        self.config = config or AcquisitionConfig()
        self.device = resolve_device(device)
        self.sample_rate = float(sample_rate)
        self.samples_per_prn = int(samples_per_prn)
        self.prns = tuple(prns)
        cfg = self.config
        self.libraries = (PEAK_REDUCE_KERNEL.source,) if cfg.use_pallas_peak_reduce else ()
        aot.preload(self.libraries, self.device)
        offsets = None
        if center_offsets_hz is not None:
            if len(center_offsets_hz) != len(self.prns):
                raise ValueError("center_offsets_hz must align with prns")
            offsets = np.asarray(center_offsets_hz, dtype=np.float32)
        if cfg.correlator not in (None, "matmul", "fft"):
            raise ValueError(
                f"AcquisitionConfig.correlator must be 'matmul', 'fft' or None, "
                f"got {cfg.correlator!r}"
            )

        reps = replica_table(self.samples_per_prn, self.prns)  # [S, L] float32 +/-1
        if offsets is not None and not all(
            np.array_equal(reps[0], reps[i]) for i in range(len(self.prns))
        ):
            raise ValueError(
                "center_offsets_hz requires all rows to share one code "
                "(an FDMA family); these PRNs have distinct codes"
            )
        # FDMA: one shared code row drives the flattened sweep.
        sweep_reps = reps[:1] if offsets is not None else reps
        dev = self.device
        # None selects the FFT sweep on every device (the JAX engine picks
        # the circulant sweep on a TPU; on the card that is a measurement's
        # call, ROADMAP item 15).
        matmul = cfg.correlator == "matmul"
        self.register_buffer("prn_fft_conj", None if matmul else torch.from_numpy(
            replica_fft_conj_table(sweep_reps)).to(dev))
        self.register_buffer(
            "circulant", build_circulant_table(sweep_reps, dev) if matmul else None,
            persistent=False)
        self.register_buffer(
            "replica_tiled", torch.from_numpy(np.concatenate([reps, reps], axis=1)).to(dev)
        )
        coarse = np.arange(
            -cfg.doppler_max_hz, cfg.doppler_max_hz + 1e-6, cfg.coarse_step_hz
        ).astype(np.float32)
        self.register_buffer("coarse_dopplers", torch.from_numpy(coarse).to(dev))
        self.register_buffer("fine_offsets", torch.from_numpy(np.arange(
            -cfg.fine_span_hz, cfg.fine_span_hz + 1e-6, cfg.fine_step_hz
        ).astype(np.float32)).to(dev))
        # FDMA: the centers, and the flattened [K * D] grid of absolute
        # baseband frequencies the sweep runs over (None otherwise).
        fdma = offsets is not None
        self.register_buffer(
            "center_offsets", torch.from_numpy(offsets).to(dev) if fdma else None)
        self.register_buffer("sweep_dopplers", torch.from_numpy(
            (offsets[:, None] + coarse[None, :]).reshape(-1)).to(dev) if fdma else None)

    # ---------------------------------------------------------------- device

    @torch.no_grad()
    def forward(self, samples_ms: torch.Tensor) -> torch.Tensor:
        """[M, L] complex64 samples on the engine's device -> [4, S] float32
        rows (doppler, code phase, carrier phase, strength)."""
        fs = self.sample_rate
        length = self.samples_per_prn
        m_count = samples_ms.shape[0]
        coarse_dopplers = self.coarse_dopplers
        fine_offsets = self.fine_offsets

        # ---- Stage 1: coarse non-coherent sweep over the full grid. FDMA
        # families flatten [channel x Doppler] into one single-code sweep
        # over the concatenated per-channel grids ([1, K*D, L]), reshaped
        # back to [K, D, L].
        fdma = self.center_offsets is not None
        dopplers = self.sweep_dopplers if fdma else coarse_dopplers
        if self.circulant is not None:  # [S, D, L]
            noncoh = noncoherent_acquisition_sweep_matmul(samples_ms, dopplers, self.circulant, fs)
        else:
            noncoh = noncoherent_acquisition_sweep(samples_ms, dopplers, self.prn_fft_conj, fs)
        if fdma:
            noncoh = noncoh.reshape(len(self.prns), coarse_dopplers.shape[0], length)
        use_kernel = self.config.use_pallas_peak_reduce
        if use_kernel is None:
            use_kernel = False  # the reference's default (config.py)
        best_d_idx, code_phase, strength = coarse_peak(noncoh, use_kernel)
        sats = torch.arange(noncoh.shape[0], device=noncoh.device)
        coarse_doppler = coarse_dopplers[best_d_idx]  # [S]
        if fdma:  # back to the absolute baseband frequency per channel
            coarse_doppler = coarse_doppler + self.center_offsets

        # ---- Stage 2: coherent fine grid at the detected code phase.
        # Prompt replica: roll(r, cp)[l] = tiled[(L - cp) + l].
        starts = torch.remainder(length - code_phase, length)
        idx = starts[:, None] + torch.arange(length, device=noncoh.device)[None, :]
        rolled = torch.gather(self.replica_tiled, 1, idx)  # [S, L] float32

        dev = samples_ms.device
        l_over_fs = torch.arange(length, dtype=torch.float32, device=dev) / fs  # [L]
        t_ms = torch.arange(m_count, dtype=torch.float32, device=dev) * (length / fs)  # [M]

        # Separable wipeoff: coarse per-sat terms x shared fine-offset basis.
        sat_intra = _phasor(coarse_doppler[:, None] * l_over_fs[None, :])  # [S, L]
        sat_chunk = _phasor(_mod_cycles(coarse_doppler[:, None] * t_ms[None, :]))  # [S, M]
        fine_intra = _phasor(fine_offsets[:, None] * l_over_fs[None, :])  # [F, L]
        fine_chunk = _phasor(_mod_cycles(fine_offsets[:, None] * t_ms[None, :]))  # [F, M]

        rolled_c = rolled.to(torch.complex64)
        fine_t = fine_intra.transpose(0, 1)  # [L, F]
        p_scan = torch.stack([
            ((samples_ms[m][None, :] * rolled_c) * sat_intra) @ fine_t  # [S, F]
            for m in range(m_count)
        ])  # [M, S, F]
        prompts = (
            p_scan.permute(1, 2, 0)  # [S, F, M]
            * sat_chunk[:, None, :]
            * fine_chunk[None, :, :]
        )

        coherent_power = prompts.sum(dim=-1).abs()  # [S, F]
        best_f_idx = torch.argmax(coherent_power, dim=-1)  # [S]
        fine_doppler = coarse_doppler + fine_offsets[best_f_idx]
        p_star = prompts[sats, best_f_idx]  # [S, M]

        # ---- Stage 3: phase-slope residual (BPSK-safe via squaring).
        if self.config.phase_slope_refinement:
            q = p_star[:, 1:] * torch.conj(p_star[:, :-1])  # [S, M-1]
            r = (q * q).sum(dim=-1)
            t_chunk = length / fs
            residual = torch.angle(r) / (2.0 * 2.0 * math.pi * t_chunk)
            doppler = fine_doppler + residual
        else:
            doppler = fine_doppler

        # Carrier phase estimate: angle of the coherent prompt sum (the
        # reference's angle(coherent_profile[peak]), gypsum/acquisition.py:136).
        carrier_phase = torch.angle(p_star.sum(dim=-1))
        return torch.stack(
            [doppler, code_phase.to(torch.float32), carrier_phase, strength]
        )

    # ------------------------------------------------------------------ host

    def acquire_all(self, samples_ms: np.ndarray) -> list[AcquisitionResult]:
        """Run the full-family search on [M, L] (or flat [M*L]) IQ.

        Returns results for the engine's whole PRN family, strongest first;
        callers filter by ``config.detection_threshold`` and their
        eligibility set (the reference filters inside the detector,
        gypsum/acquisition.py:52-68)."""
        samples = np.asarray(samples_ms)
        if samples.ndim == 1:
            samples = samples.reshape(-1, self.samples_per_prn)
        if samples.shape != (self.config.integration_period_ms, self.samples_per_prn):
            raise ValueError(
                f"expected [{self.config.integration_period_ms}, {self.samples_per_prn}] "
                f"samples, got {samples.shape}"
            )
        x = torch.from_numpy(np.ascontiguousarray(samples, dtype=np.complex64)).to(self.device)
        doppler, code_phase, carrier_phase, strength = self(x).cpu().numpy()
        results = [
            AcquisitionResult(
                prn=self.prns[i],
                doppler_hz=float(doppler[i]),
                code_phase_samples=int(code_phase[i]),
                carrier_phase_rad=float(carrier_phase[i]),
                strength=float(strength[i]),
            )
            for i in range(len(self.prns))
        ]
        results.sort(key=lambda r: -r.strength)
        return results

    def detect(
        self, samples_ms: np.ndarray, eligible_prns: set[int] | None = None
    ) -> list[AcquisitionResult]:
        """Detected satellites only (strength above threshold), optionally
        restricted to an eligibility set."""
        return [
            r
            for r in self.acquire_all(samples_ms)
            if r.strength > self.config.detection_threshold
            and (eligible_prns is None or r.prn in eligible_prns)
        ]


# AcquisitionEngine is stateless across detect() calls: one engine per
# distinct (rate, L, config, PRN family, device) serves every Receiver in
# the process, so restarting a receiver does not rebuild its tables. Every
# fetch starts the preload of the engine's kernels, as a construction does.
_ENGINE_CACHE: dict = {}


def shared_acquisition_engine(
    sample_rate: float,
    samples_per_prn: int,
    config: "AcquisitionConfig | None" = None,
    prns: tuple[int, ...] = ALL_PRN_IDS,
    center_offsets_hz: "tuple[float, ...] | None" = None,
    device: str | torch.device = "cuda",
) -> AcquisitionEngine:
    prns = tuple(prns)
    offsets = None if center_offsets_hz is None else tuple(center_offsets_hz)
    dev = resolve_device(device)
    key = (float(sample_rate), int(samples_per_prn), config, prns, offsets, str(dev))
    try:
        eng = _ENGINE_CACHE.get(key)
    except TypeError:  # unhashable config: build uncached
        return AcquisitionEngine(sample_rate, samples_per_prn, config, prns, offsets, dev)
    if eng is None:
        eng = _ENGINE_CACHE[key] = AcquisitionEngine(
            sample_rate, samples_per_prn, config, prns, offsets, dev
        )
    else:
        aot.preload(eng.libraries, dev)
    return eng
