"""High-sensitivity ("deep") acquisition: hundreds of milliseconds of
grouped coherent x non-coherent integration.

Torch port of gypsum_tpu/acquire/deep.py. The 10 ms engine
(acquire/engine.py) matches the reference's sensitivity envelope
(gypsum/config.py:4: 10 ms non-coherent). This engine goes ~7-10 dB deeper,
where the reference cannot see a satellite at all:

- The capture is split into G groups of ``coherent_ms`` milliseconds. Within
  a group, per-ms circular correlations are summed COHERENTLY (the Doppler
  wipeoff keeps phase continuous across the whole capture), multiplying the
  peak amplitude by the group length; groups then accumulate non-coherently
  (|.|), adding another ~sqrt(G).
- The Doppler grid is matched to the group main lobe: step = 1000 /
  (2 * coherent_ms) Hz (50 Hz for 10 ms groups), so the worst-case bin
  straddle loss is bounded, and the final squared phase-slope refinement
  (group-to-group) resolves exactly the +/- half-bin residual.
- Code Doppler is compensated: each group's profile is circularly shifted to
  group-0 coordinates with a per-(bin, group) STATIC shift before
  accumulation (``_roll_indices``, host numpy as in the JAX package).
- Memory is bounded by chunking the Doppler axis: one sweep evaluates
  ``doppler_chunk`` bins over the whole capture ([S, C, L] accumulator); the
  host loops chunks and keeps per-chunk (peak, argmax, sum) only.

Two differences from the JAX program, neither a change of function:

- The JAX sweep inverse-FFTs every millisecond's product and then sums the
  group's ``coherent_ms`` results. The FFT is linear, so this port sums the
  group's forward FFTs first and inverse-FFTs once per group: the same
  function with a ``coherent_ms`` times smaller [S, C, G, L] working set
  (float32 sums in another order; tests/test_torch_deep_acquire.py holds it
  to the JAX engine). The TPU's ``ifft_via_fft`` workaround is not ported:
  cuFFT (``torch.fft.ifft``) runs the inverse transform directly.
- The per-chunk reduction of the [S, C, L] accumulator to (peak, argmax,
  sum) over L goes through K2 (``ops/peak_reduce.py``) on [S*C, L] rows: the
  hand-written kernel on a CUDA tensor, its plain version on the CPU. K2's
  argmax takes the lowest index on ties, as ``jnp.argmax`` does.

At these signal levels the 1 kHz Costas/DLL loops cannot hold lock, so a
deep hit's payoff is its CODE PHASE: feed it to snapshot coarse-time
positioning (solve/snapshot.py), which needs no tracking or decode.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gypsum_tpu_torch.acquire.engine import AcquisitionResult
from gypsum_tpu_torch.core import aot
from gypsum_tpu_torch.core.config import DeepAcquisitionConfig
from gypsum_tpu_torch.core.constants import GPS_L1_FREQUENCY_HZ
from gypsum_tpu_torch.core.device import resolve_device
from gypsum_tpu_torch.ops.correlate import doppler_wipeoff, replica_fft_conj_table
from gypsum_tpu_torch.ops.peak_reduce import PEAK_REDUCE_KERNEL, peak_reduce
from gypsum_tpu_torch.signal.prn import ALL_PRN_IDS, replica_table


class DeepAcquisitionEngine:
    """Whole-family deep search on ``device`` (CUDA unless the caller asks
    for the CPU); one sweep per Doppler chunk, each reduced by K2
    (``libraries``), whose preload construction starts (``core/aot.py``)."""

    def __init__(
        self,
        sample_rate: float,
        samples_per_prn: int,
        config: DeepAcquisitionConfig | None = None,
        prns: tuple[int, ...] = ALL_PRN_IDS,
        carrier_hz: float = GPS_L1_FREQUENCY_HZ,
        device: str | torch.device = "cuda",
    ) -> None:
        """``carrier_hz``: the passband carrier the code-Doppler
        compensation scales against (GPS L1 default; a GLONASS deep search
        passes the L1OF base — see deep_acquire_glonass)."""
        self.config = cfg = config or DeepAcquisitionConfig()
        if cfg.total_ms % cfg.coherent_ms:
            raise ValueError(
                f"total_ms {cfg.total_ms} not a multiple of coherent_ms "
                f"{cfg.coherent_ms}"
            )
        self.device = resolve_device(device)
        self.libraries = (PEAK_REDUCE_KERNEL.source,)
        aot.preload(self.libraries, self.device)
        self.sample_rate = float(sample_rate)
        self.samples_per_prn = int(samples_per_prn)
        self.prns = tuple(prns)
        self.carrier_hz = float(carrier_hz)
        self.n_groups = cfg.total_ms // cfg.coherent_ms

        reps = replica_table(self.samples_per_prn, self.prns)  # [S, L] +/-1
        self._prn_fft_conj = torch.from_numpy(replica_fft_conj_table(reps)).to(self.device)
        self._replica_tiled = np.concatenate([reps, reps], axis=1)

        # Adaptive threshold: measured noise-only normalized peaks sit at
        # ~1 + 7/sqrt(G) over the full grid; k=10 leaves ~40% margin.
        self.detection_threshold = (
            cfg.detection_threshold
            if cfg.detection_threshold is not None
            else 1.0 + cfg.detection_k / np.sqrt(self.n_groups)
        )
        step = cfg.doppler_step_hz or 1000.0 / (2.0 * cfg.coherent_ms)
        self.dopplers = np.arange(
            cfg.doppler_center_hz - cfg.doppler_span_hz,
            cfg.doppler_center_hz + cfg.doppler_span_hz + 1e-6,
            step,
        ).astype(np.float32)

    # ------------------------------------------------------------- device

    def _roll_indices(self, dopplers_chunk: np.ndarray) -> np.ndarray:
        """[G, C, L] int32 gather indices aligning each group's profile to
        group-0 code-phase coordinates (static per bin/group)."""
        length = self.samples_per_prn
        cfg = self.config
        g_t = (np.arange(self.n_groups) + 0.5) * cfg.coherent_ms * 1e-3  # [G]
        # Code-phase drift rate: the tracker's carrier-aiding constant
        # (track/loop.py aiding_scale): samples/s = f_d * L * 1000 / f_car.
        rate = dopplers_chunk * (length * 1e3 / self.carrier_hz)  # [C] /s
        if not cfg.compensate_code_doppler:
            rate = np.zeros_like(rate)
        shift = np.round(rate[None, :] * g_t[:, None]).astype(np.int64)  # [G, C]
        l_idx = np.arange(length, dtype=np.int64)
        idx = np.mod(l_idx[None, None, :] - shift[:, :, None], length)
        return idx.astype(np.int32)

    def accumulate(
        self, samples: torch.Tensor, dopplers_chunk: torch.Tensor, roll_idx: torch.Tensor
    ) -> torch.Tensor:
        """samples [T, L] complex64, dopplers_chunk [C] float32, roll_idx
        [G, C, L] int64 -> the [S, C, L] float32 accumulator: per PRN and
        bin, the sum over groups of |coherent group correlation|, each group
        aligned to group-0 code phase."""
        cfg = self.config
        length = self.samples_per_prn
        c_count = dopplers_chunk.shape[0]
        shifted = doppler_wipeoff(samples, dopplers_chunk, self.sample_rate)  # [C, T, L]
        ffts = torch.fft.fft(shifted, dim=-1)
        # Sum each group's forward FFTs (linearity; see the module docstring).
        group_ffts = ffts.reshape(c_count, self.n_groups, cfg.coherent_ms, length).sum(dim=2)
        corr = torch.fft.ifft(
            group_ffts[None, :, :, :] * self._prn_fft_conj[:, None, None, :], dim=-1
        )  # [S, C, G, L]
        coh = corr.abs()
        idx = roll_idx.permute(1, 0, 2)[None].expand(coh.shape[0], -1, -1, -1)
        return torch.gather(coh, -1, idx).sum(dim=2)

    def _sweep_chunk(
        self, samples: torch.Tensor, dopplers_chunk: torch.Tensor, roll_idx: torch.Tensor
    ) -> np.ndarray:
        """-> host [3, S, C]: (peak, argmax in group-0 coordinates, sum)."""
        total = self.accumulate(samples, dopplers_chunk, roll_idx)
        s_count, c_count, length = total.shape
        peak, arg, tot = peak_reduce(total.reshape(s_count * c_count, length))
        packed = torch.stack([peak, arg.to(torch.float32), tot])
        return packed.cpu().numpy().reshape(3, s_count, c_count)

    def _refine(self, samples: torch.Tensor, doppler: float, rolled_replica: np.ndarray):
        """Squared group-to-group phase slope at the winning (doppler, code
        phase): residual Doppler within +/- 1/(4 Nc ms) plus carrier phase.
        ``rolled_replica``: [L] replica aligned to the winning code phase."""
        cfg = self.config
        dev = samples.device
        dop = torch.tensor([doppler], dtype=torch.float32, device=dev)
        shifted = doppler_wipeoff(samples, dop, self.sample_rate)[0]  # [T, L]
        rep = torch.from_numpy(rolled_replica.astype(np.float32)).to(dev)
        prompts = (shifted * rep[None, :]).sum(dim=-1)  # [T] per-ms
        groups = prompts.reshape(self.n_groups, cfg.coherent_ms).sum(dim=-1)
        q = groups[1:] * torch.conj(groups[:-1])
        r = torch.sum(q * q)
        t_group = cfg.coherent_ms * 1e-3
        out = torch.stack([
            torch.angle(r) / (2.0 * 2.0 * math.pi * t_group),
            torch.angle(groups.sum()),
        ]).cpu().numpy()
        return float(out[0]), float(out[1])

    # --------------------------------------------------------------- host

    def acquire_all(self, samples_ms) -> list[AcquisitionResult]:
        """[total_ms, L] (or flat) IQ, numpy or a tensor -> per-PRN deep
        estimates, strongest first (filter with ``detection_threshold``)."""
        cfg = self.config
        length = self.samples_per_prn
        samples = torch.as_tensor(samples_ms).to(self.device, torch.complex64)
        if samples.dim() == 1:
            samples = samples.reshape(-1, length)
        if tuple(samples.shape) != (cfg.total_ms, length):
            raise ValueError(
                f"expected [{cfg.total_ms}, {length}] samples, got {tuple(samples.shape)}"
            )

        c = cfg.doppler_chunk
        n_bins = len(self.dopplers)
        best = np.full((len(self.prns), 3), -np.inf)  # peak, doppler, cp
        sums = np.zeros(len(self.prns))
        for start in range(0, n_bins, c):
            chunk = self.dopplers[start : start + c]
            if len(chunk) < c:  # pad to the chunk shape; dupes are harmless
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], c - len(chunk))])
            peak, arg, tot = self._sweep_chunk(
                samples,
                torch.from_numpy(chunk).to(self.device),
                torch.from_numpy(self._roll_indices(chunk).astype(np.int64)).to(self.device),
            )
            for s in range(len(self.prns)):
                ci = int(np.argmax(peak[s]))
                if peak[s, ci] > best[s, 0]:
                    best[s] = (peak[s, ci], chunk[ci], arg[s, ci])
                    sums[s] = tot[s, ci]

        results = []
        for s, prn in enumerate(self.prns):
            peak_v, doppler, cp = best[s]
            mean_rest = (sums[s] - peak_v) / (length - 1)
            strength = float(peak_v / mean_rest)
            residual = 0.0
            phase = 0.0
            if cfg.phase_slope_refinement:
                start_i = int((length - cp) % length)
                rolled = self._replica_tiled[s, start_i : start_i + length]
                residual, phase = self._refine(samples, float(np.float32(doppler)), rolled)
            results.append(
                AcquisitionResult(
                    prn=prn,
                    doppler_hz=float(doppler) + residual,
                    code_phase_samples=int(cp),
                    carrier_phase_rad=phase,
                    strength=strength,
                )
            )
        results.sort(key=lambda r: -r.strength)
        return results

    def detect(self, samples_ms, eligible_prns: set[int] | None = None) -> list[AcquisitionResult]:
        return [
            r
            for r in self.acquire_all(samples_ms)
            if r.strength > self.detection_threshold
            and (eligible_prns is None or r.prn in eligible_prns)
        ]


def deep_acquire_glonass(
    samples_ms: np.ndarray,
    sample_rate: float,
    samples_per_prn: int,
    config: DeepAcquisitionConfig | None = None,
    prns: "tuple[int, ...] | None" = None,
    device: str | torch.device = "cuda",
) -> list[AcquisitionResult]:
    """Deep (grouped coherent x non-coherent) search over the GLONASS L1OF
    FDMA family: ~7-10 dB below the standard 10 ms engine, per channel.

    Every GLONASS satellite transmits the SAME 511-chip SP code on its own
    k * 562.5 kHz sub-band, so the deep sweep runs ONE single-code engine
    and visits channels by pre-rotating the capture to each sub-band's
    center — in float64 on the host, as the JAX package does: at |offset| up
    to ~3.9 MHz a float32 phase of the device wipeoff would smear ~45 deg per
    ms into the coherent group sums. The engine is built once and reused for
    all channels (same shapes).

    Results report the ABSOLUTE baseband frequency (sub-band center +
    Doppler), matching the standard engine's FDMA convention. A deep hit's
    payoff is its code phase (the 1 kHz loops cannot hold lock this weak):
    feed it to snapshot positioning or a warm tracker start.
    """
    from gypsum_tpu_torch.core.constants import (
        GLONASS_L1_BASE_HZ,
        GLONASS_L1_CHANNEL_SPACING_HZ,
    )
    from gypsum_tpu_torch.signal.prn import GLONASS_PRN_IDS, glonass_frequency_number

    family = tuple(prns) if prns is not None else GLONASS_PRN_IDS
    bad = set(family) - set(GLONASS_PRN_IDS)
    if bad:
        raise ValueError(f"not GLONASS channel ids (201..214): {sorted(bad)}")
    cfg = config or DeepAcquisitionConfig()
    length = int(samples_per_prn)
    samples = np.asarray(samples_ms)
    if samples.ndim == 2:
        samples = samples.reshape(-1)
    n = cfg.total_ms * length
    if samples.shape[0] < n:
        raise ValueError(
            f"need {cfg.total_ms} ms ({n} samples), got {samples.shape[0]}"
        )
    samples = samples[:n]
    eng = DeepAcquisitionEngine(
        sample_rate, length, cfg, prns=family[:1],
        carrier_hz=GLONASS_L1_BASE_HZ, device=device,
    )
    t = np.arange(n, dtype=np.float64) / float(sample_rate)
    out: list[AcquisitionResult] = []
    for prn in family:
        offset = glonass_frequency_number(prn) * GLONASS_L1_CHANNEL_SPACING_HZ
        rotated = (
            samples.astype(np.complex128)
            * np.exp(-2j * np.pi * offset * t)
        ).astype(np.complex64).reshape(cfg.total_ms, length)
        r = eng.acquire_all(rotated)[0]
        out.append(
            AcquisitionResult(
                prn=prn,
                doppler_hz=r.doppler_hz + offset,
                code_phase_samples=r.code_phase_samples,
                carrier_phase_rad=r.carrier_phase_rad,
                strength=r.strength,
            )
        )
    out.sort(key=lambda r: -r.strength)
    return out
